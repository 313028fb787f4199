"""How the multi-tensor optimizer kernels cut a list (``csrc/multi_tensor_
adam.cu``, ``csrc/multi_tensor_sgd.cu``), on the CPU: the chunk the
wrappers pick per list and card (``kernels.multi_tensor._chunk_for``) at
the port's own models' parameter lists, the device table at that chunk
(``_table``), the launcher's split of a long list and what it passes the C
entry points, and their ctypes signatures (the libraries are built on the
card; here ``_build.load`` is stood in for).  Both updates are elementwise,
so the chunk changes no bit of them; ``chip_smoke.py`` holds the kernels
to their plain versions at every chunk the lists pick, on the card.
"""
import contextlib
import ctypes
import functools
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from apex_tpu_torch import models  # noqa: E402
from apex_tpu_torch.kernels import multi_tensor  # noqa: E402
from apex_tpu_torch.kernels.dispatch import LAUNCHES  # noqa: E402
from apex_tpu_torch.models import dcgan, gpt  # noqa: E402

LARGEST = 65536
# the amp O1 paths' lists, which are short, and the training paths' lists
SHORT = ("dcgan_generator", "dcgan_discriminator", "resnet18")
TRAINING = ("resnet50", "gpt2_small")
# bytes moved per element: fp32 Adam (g read; p, m, v read and written),
# GPT's Adam with bf16 gradients, amp O3's all-fp16 Adam, fp32 SGD
FP32_ADAM, BF16_GRAD_ADAM, FP16_ADAM, FP32_SGD = 28, 26, 14, 20
STEP_BYTES = {"dcgan_generator": FP32_ADAM, "dcgan_discriminator": FP32_ADAM,
              "resnet18": FP32_SGD, "resnet50": FP32_SGD,
              "gpt2_small": BF16_GRAD_ADAM}


@functools.lru_cache(maxsize=None)
def _sizes(name):
    """The parameter sizes of one of the port's models, in order."""
    build = {
        "dcgan_generator": lambda: dcgan.build_generator(100, 64,
                                                         device="cpu"),
        "dcgan_discriminator": lambda: dcgan.build_discriminator(
            64, device="cpu"),
        "resnet18": lambda: models.resnet18(num_classes=10,
                                            small_input=True, device="cpu"),
        "resnet50": lambda: models.resnet50(device="cpu"),
        "gpt2_small": lambda: gpt.gpt2_small(max_positions=1024,
                                             device="cpu"),
    }[name]
    with torch.no_grad():
        return tuple(p.numel() for p in build().parameters())


def _count(sizes, chunk):
    return sum(-(-n // chunk) for n in sizes)


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("name", SHORT + TRAINING)
def test_chunk_is_the_largest_power_of_two_that_fills_the_card(name, sms):
    sizes, step = _sizes(name), STEP_BYTES[name]
    chunk = multi_tensor._chunk_for(sizes, sms, step)
    assert chunk & (chunk - 1) == 0 and chunk % 8 == 0
    assert multi_tensor.MIN_CHUNK <= chunk <= LARGEST
    # a chunk's reads and writes stay within CHUNK_BYTES ...
    assert chunk * step <= multi_tensor.CHUNK_BYTES
    target = multi_tensor.CHUNKS_PER_SM * sms
    # ... it gives every SM enough chunks, unless the floor stops the
    # halving ...
    assert _count(sizes, chunk) >= target or chunk == multi_tensor.MIN_CHUNK
    # ... and it is the largest chunk that does both
    assert 2 * chunk * step > multi_tensor.CHUNK_BYTES \
        or _count(sizes, 2 * chunk) < target


@pytest.mark.parametrize("name,chunk,count", [
    ("dcgan_generator", 2048, 532), ("dcgan_discriminator", 1024, 655),
    ("resnet18", 2048, 5493)])
def test_short_lists_give_the_h100_several_chunks_an_sm(name, chunk, count):
    """At the H100's 132 SMs the O1 lists cut into 19-33 times more
    chunks than the 20-220 of a fixed 65536-element chunk."""
    sizes = _sizes(name)
    assert _count(sizes, LARGEST) <= 220
    assert multi_tensor._chunk_for(sizes, 132, STEP_BYTES[name]) == chunk
    assert _count(sizes, chunk) == count


@pytest.mark.parametrize("name", TRAINING)
def test_training_lists_keep_the_largest_chunk(name):
    """A long list takes the largest chunk within CHUNK_BYTES: 2048
    elements in fp32, 4096 with amp O3's fp16 parameters and moments."""
    sizes = _sizes(name)
    assert multi_tensor._chunk_for(sizes, 132, STEP_BYTES[name]) == 2048
    assert multi_tensor._chunk_for(sizes, 132, FP16_ADAM) == 4096


def test_chunk_is_at_most_the_largest_the_library_takes():
    assert multi_tensor._chunk_for([10 ** 9], 132, 1, largest=512) == 512
    assert multi_tensor._chunk_for([10 ** 9], 132, 1) == \
        multi_tensor.CHUNK_BYTES
    assert multi_tensor._chunk_for([], 132, 28) == multi_tensor.MIN_CHUNK
    assert multi_tensor._chunk_for([1, 0, 7], 132, 28) == \
        multi_tensor.MIN_CHUNK


def test_step_bytes_count_the_gradient_once_and_the_rest_twice():
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16

    def lists(*dtypes):
        return [[torch.zeros(2, dtype=d)] for d in dtypes]
    assert multi_tensor._step_bytes(lists(f32, f32, f32, f32)) == FP32_ADAM
    assert multi_tensor._step_bytes(lists(bf16, f32, f32, f32)) == \
        BF16_GRAD_ADAM
    assert multi_tensor._step_bytes(lists(f16, f16, f16, f16)) == FP16_ADAM
    assert multi_tensor._step_bytes(lists(f32, f32, f32)) == FP32_SGD
    # a list of mixed gradients counts its widest
    mixed = [[torch.zeros(2, dtype=bf16), torch.zeros(2)], [torch.zeros(2)] * 2,
             [torch.zeros(2)] * 2]
    assert multi_tensor._step_bytes(mixed) == FP32_SGD


class _Tensor:
    """What ``_table`` reads of a tensor: its size, address and device."""

    def __init__(self, n, addr):
        self.n, self.addr, self.device = n, addr, torch.device("cpu")

    def numel(self):
        return self.n

    def data_ptr(self):
        return self.addr


def _decode(table, nt):
    t = table.numpy()
    return (t[:3 * nt].reshape(3, nt), t[3 * nt:4 * nt],
            t[4 * nt:].reshape(-1, 2))


@pytest.mark.parametrize("name", SHORT + TRAINING)
def test_table_at_the_chosen_chunk_covers_every_element_once(name):
    # the model's tensors with empty ones among them
    sizes = list(_sizes(name))
    sizes[1:1] = [0]
    sizes.append(0)
    chunk = multi_tensor._chunk_for(sizes, 132, STEP_BYTES[name])
    lists = [[_Tensor(n, 4096 * (3 * i + k + 1)) for i, n in enumerate(sizes)]
             for k in range(3)]
    table, nc = multi_tensor._table(*lists, chunk)
    addrs, got_sizes, chunks = _decode(table, len(sizes))
    for row, lst in zip(addrs, lists):
        assert list(row) == [t.data_ptr() for t in lst]
    assert list(got_sizes) == sizes
    assert nc == len(chunks) == _count(sizes, chunk)
    owner, offset = chunks[:, 0], chunks[:, 1]
    assert np.all(offset % chunk == 0)
    covered = np.zeros(len(sizes), np.int64)
    for t in range(len(sizes)):
        mine = np.sort(offset[owner == t])
        # chunks of one tensor start at 0, one chunk apart, and end at its
        # size: each element lies in exactly one chunk
        assert list(mine) == list(range(0, sizes[t], chunk))
        covered[t] = sum(min(chunk, sizes[t] - o) for o in mine)
    assert list(covered) == sizes
    assert not np.isin(np.flatnonzero(np.array(sizes) == 0), owner).any()
    # the chunk is part of the kept table's key
    assert multi_tensor._table(*lists, chunk)[0] is table
    assert multi_tensor._table(*lists, 2 * chunk)[1] \
        == _count(sizes, 2 * chunk)


class _FakeLib:
    """Stands in for a built library: records each launch's arguments."""

    def __init__(self, kind):
        self.kind, self.calls = kind, []

    def max_tensors(self):
        return 256

    def largest(self):
        return LARGEST

    def launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """Run a wrapper's launcher on CPU tensors: the library, the device
    context, the stream and the SM count stood in for."""
    def install(kind):
        lib = _FakeLib(kind)
        ns = types.SimpleNamespace(**{
            f"apex_{kind}_max_tensors": lib.max_tensors,
            f"apex_{kind}_chunk": lib.largest, f"apex_{kind}": lib.launch})
        monkeypatch.setattr(multi_tensor, f"_{kind}_lib", lambda: ns)
        monkeypatch.setattr(multi_tensor, "_sms", lambda index: SPLIT_SMS)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
        return lib
    return install


# 300 tensors, more than one launch takes, on a card of 16 SMs: the first
# launch's 256 tensors fill it at the largest chunk (2048 elements in fp32),
# the second launch's 20 (and 4 empty ones) only at the smallest
SPLIT_SMS = 16


def _split_sizes():
    return [1500] * 256 + [0] * 4 + [1500] * 20 + [0] * 20


def test_adam_launcher_splits_long_lists_and_passes_each_its_chunk(
        fake_launch):
    lib = fake_launch("adam")
    sizes = _split_sizes()
    lists = [[torch.zeros(n) for n in sizes] for _ in range(4)]
    scal = multi_tensor.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 1, True, 0.0,
                                     "cpu")
    flag = torch.zeros(1, dtype=torch.int32)
    before = LAUNCHES["fused_adam"]
    multi_tensor._launch_adam(flag, lists, scal, 1, False)
    assert LAUNCHES["fused_adam"] - before == 2
    subs = [slice(0, 256), slice(256, 300)]
    for call, sub in zip(lib.calls, subs):
        grads, table, nt, nc, chunk = call[:5]
        want = multi_tensor._chunk_for(sizes[sub], SPLIT_SMS, FP32_ADAM)
        assert (nt, chunk) == (len(sizes[sub]), want)
        assert nc == _count(sizes[sub], want)
        # (ctypes reads a null address back as None: the empty tensors')
        assert [grads[i] or 0 for i in range(nt)] == \
            [g.data_ptr() for g in lists[0][sub]]
        kept, kept_nc = multi_tensor._table(lists[1][sub], lists[2][sub],
                                            lists[3][sub], want)
        assert (table, nc) == (kept.data_ptr(), kept_nc)
    assert [c[4] for c in lib.calls] == [2048, multi_tensor.MIN_CHUNK]


def test_sgd_launcher_splits_long_lists_and_passes_each_its_chunk(
        fake_launch):
    lib = fake_launch("sgd")
    sizes = _split_sizes()
    gs = [torch.zeros(n, dtype=torch.bfloat16 if i % 2 else torch.float32)
          for i, n in enumerate(sizes)]
    ps, ms = ([torch.zeros(n) for n in sizes] for _ in range(2))
    cs = [torch.zeros(n, dtype=torch.float16) for n in sizes]
    scal = multi_tensor.sgd_scalars(0.1, 0.0, 1.0, 0.9, 0.0, "cpu")
    flag = torch.zeros(1, dtype=torch.int32)
    before = LAUNCHES["fused_sgd"]
    multi_tensor._launch_sgd(flag, [gs, ps, ms, cs], scal, True, False,
                             False, False, False)
    assert LAUNCHES["fused_sgd"] - before == 2
    for call, sub in zip(lib.calls, (slice(0, 256), slice(256, 300))):
        grads, codes, table, nt, nc, chunk = call[:6]
        # (bf16 and fp32 gradients, fp32 p and m, an fp16 copy)
        want = multi_tensor._chunk_for(sizes[sub], SPLIT_SMS, 4 + 16 + 4)
        assert (nt, nc, chunk) == (len(sizes[sub]),
                                   _count(sizes[sub], want), want)
        assert [codes[i] for i in range(nt)] == \
            [multi_tensor.dtype_code(g.dtype) for g in gs[sub]]
        assert table == multi_tensor._table(ps[sub], ms[sub], cs[sub],
                                            want)[0].data_ptr()
        assert call[8:10] == (multi_tensor.dtype_code(torch.float32),
                              multi_tensor.dtype_code(torch.float16))
    assert [c[5] for c in lib.calls] == [2048, multi_tensor.MIN_CHUNK]


def test_argtypes_match_the_entry_points(monkeypatch):
    """The ctypes signatures the wrappers declare: pointers as void*, the
    tensor count, chunk count, chunk and dtype codes as int."""
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    monkeypatch.setattr(multi_tensor._build, "load",
                        lambda name: libs.setdefault(
                            name, types.SimpleNamespace(**{
                                fn: types.SimpleNamespace() for fn in (
                                    "apex_adam_max_tensors",
                                    "apex_adam_chunk", "apex_adam",
                                    "apex_sgd_max_tensors", "apex_sgd_chunk",
                                    "apex_sgd")})))
    for get in (multi_tensor._adam_lib, multi_tensor._sgd_lib):
        get.cache_clear()
        try:
            get()
        finally:
            get.cache_clear()
    adam, sgd = libs["multi_tensor_adam"], libs["multi_tensor_sgd"]
    # grads, table, nt, nc, chunk, scal, flag, gdtype, use_wd, decoupled,
    # pdtype, mdtype, vdtype, stream
    assert adam.apex_adam.argtypes == [ctypes.POINTER(p), p, i, i, i, p, p,
                                       i, i, i, i, i, i, p]
    # grads, gdtypes, table, nt, nc, chunk, scal, flag, pdtype, cdtype,
    # use_wd, wd_after, has_mom, first_run, nesterov, stream
    assert sgd.apex_sgd.argtypes == [ctypes.POINTER(p),
                                     ctypes.POINTER(ctypes.c_ubyte), p, i, i,
                                     i, p, p, i, i, i, i, i, i, i, p]
    for lib, kind in ((adam, "adam"), (sgd, "sgd")):
        assert getattr(lib, f"apex_{kind}").restype is i
        for fn in (f"apex_{kind}_max_tensors", f"apex_{kind}_chunk"):
            assert getattr(lib, fn).argtypes == []
            assert getattr(lib, fn).restype is i
