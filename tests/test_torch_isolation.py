"""The port stands alone: ``apex_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package (nor ``ml_dtypes`` or
``orbax``, which the JAX package's checkpoints use), and the port's entry
points refuse to run quietly on the CPU when no card is present."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from apex_tpu_torch.RNN import LSTM
from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn, \
    SelfMultiheadAttn
from apex_tpu_torch.models import GptModel, TransformerSeq2Seq, VitModel, \
    gpt2_small, resnet18, resnet_from_torch
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.runtime import DataPrefetcher

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "apex_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "apex_tpu", "ml_dtypes", "orbax")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    return sorted(paths)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import apex_tpu_torch\n"
        "for m in pkgutil.walk_packages(apex_tpu_torch.__path__, "
        "'apex_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules if n.startswith("
        "'apex_tpu_torch.')]), bad)\n"
        "print(' '.join(n for n in sys.modules if n.startswith("
        "'apex_tpu_torch.')))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 12     # every module was imported
    loaded = set(res.stdout.splitlines()[1].split())
    for name in ("optimizers.fused_novograd", "contrib.optimizers.fused_adam",
                 "contrib.optimizers.fused_lamb",
                 "contrib.optimizers.fp16_optimizer", "mlp.mlp",
                 "reparameterization.reparameterization",
                 "reparameterization.weight_norm", "reparameterization.lora",
                 "contrib.multihead_attn.encdec_multihead_attn",
                 "models.seq2seq", "models.vit", "nn.modules", "RNN.cells",
                 "RNN.RNNBackend", "RNN.models", "models.hf",
                 "runtime.executor", "runtime.step_cache", "runtime.data",
                 "inference.quant", "inference.decode", "inference.rolling",
                 "inference.session", "inference.speculative",
                 "inference.beam", "inference.draft", "utils.jit_cache",
                 "runtime.chaos", "runtime.resilience", "runtime.elastic",
                 "utils.checkpoint"):
        assert f"apex_tpu_torch.{name}" in loaded, name


def test_port_sources_import_nothing_of_jax():
    paths = _port_sources()
    assert len(paths) >= 15
    for path in paths:
        with open(path) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src, path)):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & set(FORBIDDEN), \
                f"{path}:{node.lineno} imports {roots}"
        for needle in ("import jax", "from jax", "from apex_tpu import",
                       "apex_tpu."):
            hits = [ln for ln in src.splitlines()
                    if needle in ln.replace("apex_tpu_torch", "")]
            assert not hits, f"{path}: {needle!r} in {hits}"


def test_package_data_ships_every_kernel_source_and_header():
    """An installed package builds its kernels from the files that the
    package data lists, so those globs must cover every source under
    ``csrc`` and every file that a source includes by a quoted name."""
    import fnmatch
    import re
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "apex_tpu_torch"]
    csrc = os.path.join(PKG, "csrc")
    names = sorted(os.listdir(csrc))
    assert any(n.endswith(".cu") for n in names)
    assert any(n.endswith(".cuh") for n in names)

    def shipped(name):
        return any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs)

    for name in names:
        assert shipped(name), f"csrc/{name} is not in the package data"
        with open(os.path.join(csrc, name)) as f:
            for inc in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(),
                                  re.M):
                assert inc in names, f"csrc/{name} includes missing {inc}"
                assert shipped(inc), f"csrc/{inc} is not in the package data"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(vocab_size=32, hidden=16, layers=1, heads=2,
                 max_positions=8)
    for build in (lambda: GptModel(**small),
                  lambda: gpt2_small(**small),
                  lambda: FusedLayerNorm(16),
                  lambda: SelfMultiheadAttn(16, 2),
                  lambda: EncdecMultiheadAttn(16, 2),
                  lambda: TransformerSeq2Seq(vocab_size=32, hidden=16,
                                             enc_layers=1, dec_layers=1,
                                             heads=2, max_positions=8),
                  lambda: VitModel(image_size=8, patch_size=4, hidden=16,
                                   layers=1, heads=2),
                  lambda: LSTM(4, 8, 1),
                  lambda: DataPrefetcher([]),
                  lambda: resnet_from_torch(resnet18(device="cpu")),
                  lambda: GptModel(**small, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert GptModel(**small, device="cpu").tok_emb.weight.device.type \
        == "cpu"


@pytest.mark.parametrize("source", sorted(
    n for n in os.listdir(os.path.join(PKG, "csrc")) if n.endswith(".cu")))
def test_every_include_of_a_kernel_source_is_package_data(source):
    """Each ``#include "..."`` of ``csrc/<source>`` names a file that
    ``pyproject.toml``'s package-data globs ship, so an installed package
    builds every kernel."""
    import fnmatch
    import re
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "apex_tpu_torch"]
    with open(os.path.join(PKG, "csrc", source)) as f:
        incs = re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)
    assert incs, f"csrc/{source} includes no local header"
    for inc in [source] + incs:
        assert os.path.isfile(os.path.join(PKG, "csrc", inc)), inc
        assert any(fnmatch.fnmatch(f"csrc/{inc}", g) for g in globs), \
            f"csrc/{inc} is not in the package data"
