#!/usr/bin/env python3
"""Time the multi-tensor optimizer kernels of one source tree, for an A/B
on one card.

    python3 tools/multi_tensor_ab.py TREE LABEL OUT.jsonl [--sweep]
    python3 tools/multi_tensor_ab.py --variant NAME DEST

TREE is a directory holding an ``apex_tpu_torch`` package: this checkout
(``.``) or another commit unpacked beside it by ``git archive`` into an
ignored directory (``build/...``).  At the amp O1 paths' lists (the Adam
kernel at the DCGAN generator's and discriminator's fp32 parameters, the
SGD kernel at ResNet-18's) and at the training shapes (Adam over GPT-2
small's parameters with bf16 gradients, and with fp16 p, m, v and
gradients as amp O3 holds them; SGD over ResNet-50's at depth 3 with the
fused step's bf16/fp32 gradients and at depth 4 with an fp16 copy), the
script times the tree's wrapper (``fused_adam`` / ``fused_sgd``) with
``chip_smoke.median_ms``: device ms warm (back-to-back calls on one list)
and cold (rotating over enough lists that 2 x the L2 lies between two uses
of one), and the host ms of enqueueing one call.  Each shape is first held
against the tree's plain version, bit for bit.  With ``--sweep`` each
shape is also timed at other chunk sizes, set in place of the wrapper's
choice (``_chunk_for``) in this process only.  One JSON line a (shape,
chunk) is printed and appended to OUT.jsonl.  To compare trees, run them
in turns in one chip call (parent, change, change, parent).

``--variant NAME DEST`` copies this checkout's ``apex_tpu_torch`` into
DEST with a design choice of the two kernels changed (VARIANTS names
them: the vectors a thread loads before it computes, a register cap for
four blocks an SM, or a grid of the blocks resident at once walking the
chunks at a stride in place of one block a chunk), to be timed as a
TREE.
"""
import importlib.util
import itertools
import json
import math
import os
import shutil
import sys

# each variant's replacements in csrc/: (file, text, replacement)
_COMMON, _SOURCES = "multi_tensor_common.cuh", ("multi_tensor_adam.cu",
                                                "multi_tensor_sgd.cu")
_RESIDENT_GRID = """// The blocks resident at once, each walking the chunks at a stride.
template <typename K> inline int resident_grid(K kernel, int nc) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MT_THREADS, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return nc < per_sm * sms ? nc : per_sm * sms;
}"""


def _unroll(u):
    return [(_COMMON, "MT_UNROLL = 1;", f"MT_UNROLL = {u};")]


def _resident():
    anchor = "template <typename T> struct Tag {"
    return [(_COMMON, anchor, _RESIDENT_GRID + "\n\n" + anchor)] \
        + [(f, "kernel<<<nc, ", "kernel<<<resident_grid(kernel, nc), ")
           for f in _SOURCES]


VARIANTS = {
    "unroll2": _unroll(2),
    "unroll4": _unroll(4),
    # at most 64 registers a thread, so that 4 blocks fit an SM
    "unroll2_4blocks": _unroll(2) + [(f, "__launch_bounds__(MT_THREADS)",
                                      "__launch_bounds__(MT_THREADS, 4)")
                                     for f in _SOURCES],
    "resident_grid": _resident(),
    "unroll4_resident_grid": _unroll(4) + _resident(),
}
# the chunks --sweep times beside the wrapper's, per shape
SWEEP = {"dcgan_generator": (1024, 2048, 4096, 8192),
         "dcgan_discriminator": (1024, 2048, 4096, 8192),
         "resnet18": (1024, 2048, 4096, 8192, 16384),
         "resnet50_depth3": (2048, 4096, 8192, 16384, 32768),
         "resnet50_depth4": (2048, 4096, 8192, 16384, 32768),
         "gpt_bf16_grads": (2048, 4096, 8192, 16384, 32768, 65536),
         "gpt_o3_fp16": (2048, 4096, 8192, 16384, 32768, 65536)}


def make_variant(name, dest):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(dest, "apex_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(here, "apex_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for file, old, new in VARIANTS[name]:
        path = os.path.join(pkg, "csrc", file)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {path} "
                               f"once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    print(f"variant {name} in {pkg}")
    return 0


def shapes(torch):
    """(name, kernel, shapes) of each timed list, from the tree's models."""
    from apex_tpu_torch import models
    from apex_tpu_torch.models import dcgan, gpt

    def of(net):
        return [tuple(p.shape) for p in net.parameters()]
    rn50 = models.resnet50(device="cpu")
    bn = {f"{mn}.{pn}" for mn, m in rn50.named_modules()
          if isinstance(m, torch.nn.BatchNorm2d)
          for pn, _ in m.named_parameters(recurse=False)}
    rn50_bn = [n in bn for n, _ in rn50.named_parameters()]
    gpt_shapes = of(gpt.gpt2_small(max_positions=1024, device="cuda"))
    return [("dcgan_generator", "adam", of(dcgan.build_generator(
                100, 64, device="cpu")), None),
            ("dcgan_discriminator", "adam", of(dcgan.build_discriminator(
                64, device="cpu")), None),
            ("resnet18", "sgd", of(models.resnet18(
                num_classes=10, small_input=True, device="cpu")), None),
            ("resnet50_depth3", "sgd", of(rn50), rn50_bn),
            ("resnet50_depth4", "sgd", of(rn50), None),
            ("gpt_bf16_grads", "adam", gpt_shapes, None),
            ("gpt_o3_fp16", "adam", gpt_shapes, None)]


def main(tree, label, out_path, sweep):
    sys.path.insert(0, os.path.abspath(tree))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("multi_tensor_ab: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch.kernels import multi_tensor as mt
    if not mt.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {mt.__file__}, not {tree}'s")
    g = torch.Generator(device="cuda").manual_seed(7)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk_for = getattr(mt, "_chunk_for", None)
    if sweep and chunk_for is None:
        raise RuntimeError(f"{tree} picks no chunk per list: nothing to "
                           f"sweep")
    res = []
    for name, kernel, shps, bn in shapes(torch):
        n_el = sum(math.prod(s) for s in shps)
        if kernel == "adam":
            pdt, gdt = {"gpt_bf16_grads": (f32, bf16),
                        "gpt_o3_fp16": (f16, f16)}.get(name, (f32, f32))
            hyper = {"gpt_bf16_grads": (6e-4, 0.9, 0.999, 1e-8, 7, 1, True,
                                        0.1),
                     "gpt_o3_fp16": (6e-4, 0.9, 0.999, 1e-4, 5, 1, True,
                                     0.1)}.get(
                name, (2e-4, 0.5, 0.999, 1e-8, 7, 1, True, 0.0))
            scal = mt.adam_scalars(*hyper[:5], hyper[6], hyper[7], "cuda")

            def make(pdt=pdt, gdt=gdt):
                return [[torch.randn(s, generator=g, device="cuda").to(gdt)
                         for s in shps],
                        [torch.randn(s, generator=g, device="cuda").to(pdt)
                         for s in shps],
                        [(torch.randn(s, generator=g, device="cuda") * 0.1)
                         .to(pdt) for s in shps],
                        [(torch.rand(s, generator=g, device="cuda") * 0.01)
                         .to(pdt) for s in shps]]

            def call(ls, hyper=hyper):
                mt.fused_adam(zero, ls, *hyper)

            def plain(ls, scal=scal, hyper=hyper):
                mt.fused_adam_reference(zero, ls, scal, hyper[5],
                                        hyper[7] != 0.0)
            esz = torch.finfo(pdt).bits // 8
            nbytes = n_el * (torch.finfo(gdt).bits // 8 + 6 * esz)
            ops = 15 * n_el
        else:
            depth4 = name == "resnet50_depth4"
            gds = ([f32 if b else bf16 for b in bn] if bn is not None
                   else [f32] * len(shps))
            hyper = ((5e-4, 0.9, 0.0, 0.1, False, False, False, 1.0)
                     if name == "resnet18" else
                     (1e-4, 0.9, 0.0, 0.1, False, False, False, 1.0))
            scal = mt.sgd_scalars(hyper[3], hyper[0], 1.0, hyper[1],
                                  hyper[2], "cuda")

            def make(gds=gds, depth4=depth4):
                ls = [[torch.randn(s, generator=g, device="cuda").to(d)
                       for s, d in zip(shps, gds)],
                      [torch.randn(s, generator=g, device="cuda")
                       for s in shps],
                      [torch.randn(s, generator=g, device="cuda") * 0.1
                       for s in shps]]
                if depth4:
                    ls.append([p.to(f16) for p in ls[1]])
                return ls

            def call(ls, hyper=hyper):
                mt.fused_sgd(zero, ls, *hyper)

            def plain(ls, scal=scal):
                mt.fused_sgd_reference(zero, ls, scal, True, False, False,
                                       False, True)
            nbytes = sum(math.prod(s) * (torch.finfo(d).bits // 8)
                         for s, d in zip(shps, gds)) + 16 * n_el \
                + (2 * n_el if depth4 else 0)
            ops = 8 * n_el
        k = max(1, math.ceil(2 * cs.L2_BYTES / nbytes))
        sets = [make() for _ in range(k)]
        bound = cs.bound_ms(nbytes, ops, cs.FP32_FLOP_PER_S)[0]
        # a tree before per-list chunks cuts every list into 65536
        own = chunk_for([math.prod(s) for s in shps], sms,
                        mt._step_bytes(sets[0])) if chunk_for else 65536
        chunks = [None] + ([c for c in SWEEP[name] if c != own]
                           if sweep else [])
        for chunk in chunks:
            if chunk is not None:
                mt._chunk_for = lambda *args, chunk=chunk: chunk
            ka = [sets[0][0]] + [[t.clone() for t in lst]
                                 for lst in sets[0][1:]]
            ra = [sets[0][0]] + [[t.clone() for t in lst]
                                 for lst in sets[0][1:]]
            call(ka)
            plain(ra)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for la, lb in zip(ka[1:], ra[1:])
                       for a, b in zip(la, lb)):
                raise AssertionError(f"{label} {name} chunk {chunk}: kernel "
                                     f"!= plain version")
            del ka, ra
            warm, host = cs.median_ms(lambda: call(sets[0]))
            it = itertools.cycle(sets)
            cold = cs.median_ms(lambda: call(next(it)))[0]
            r = dict(label=label, shape=name, tensors=len(shps),
                     elements=n_el, chunk=chunk or own,
                     chunk_is_the_wrappers=chunk is None, warm_ms=warm,
                     cold_ms=cold, host_ms=host, cold_sets=k,
                     bound_ms=bound, card=card)
            res.append(r)
            print(json.dumps(r), flush=True)
            if chunk_for:
                mt._chunk_for = chunk_for
        del sets
    with open(out_path, "a") as f:
        for r in res:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        sys.exit(make_variant(sys.argv[2], sys.argv[3]))
    if len(sys.argv) in (4, 5) and sys.argv[1] != "--variant" \
            and sys.argv[4:] in ([], ["--sweep"]):
        sys.exit(main(*sys.argv[1:4], sweep=len(sys.argv) == 5))
    sys.exit(__doc__)
