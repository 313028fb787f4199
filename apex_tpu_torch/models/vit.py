"""Vision Transformer family, the PyTorch counterpart of
``apex_tpu/models/vit.py``.

The standard ViT shape (Dosovitskiy et al.): a conv patchify
(``nn.Conv2d`` with stride = patch), a prepended CLS token and learned
positions, pre-LN blocks of ``SelfMultiheadAttn(impl="fast")``
(non-causal, through the flash kernels at 197 tokens for 224 / 16: the
last tile of keys and rows is partial) and a tanh-GELU FFN, the final
LayerNorm on the CLS state, then the classifier head.  Every LayerNorm
runs the LayerNorm kernels.  ``remat`` runs each block through
:func:`apex_tpu_torch.nn.checkpoint_forward`.  In training mode the
dropout masks are drawn from the ``generator`` passed to ``forward``.
Parameter names are the JAX package's (``cls_token``, ``pos_emb``,
``patch_embed.weight``, ...), so
:func:`apex_tpu_torch.models.convert.from_jax_state_dict` carries weights
across one to one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..contrib.multihead_attn import SelfMultiheadAttn
from ..kernels.dispatch import resolve_device
from ..nn.modules import checkpoint_forward
from ..normalization import FusedLayerNorm
from .gpt import dropout


class VitBlock(nn.Module):
    """Pre-LN encoder block: LN -> MHA -> residual, LN -> GELU FFN ->
    residual."""

    def __init__(self, hidden, heads, intermediate, dropout=0.0,
                 attn_dropout=0.0, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ln1 = FusedLayerNorm(hidden, **kw)
        self.attn = SelfMultiheadAttn(hidden, heads, dropout=attn_dropout,
                                      impl="fast", **kw)
        self.ln2 = FusedLayerNorm(hidden, **kw)
        self.fc1 = nn.Linear(hidden, intermediate, **kw)
        self.fc2 = nn.Linear(intermediate, hidden, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, generator=None):
        """``x (S, B, E)``; ``generator`` draws the dropout masks."""
        p = self.dropout.p
        h, _ = self.attn(self.ln1(x), generator=generator)
        x = x + dropout(h, p, self.training, generator)
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + dropout(self.fc2(h), p, self.training, generator)


class VitModel(nn.Module):
    """``forward(images (B, 3, H, W)) -> logits (B, num_classes)``.  Runs
    on the CUDA card unless ``device="cpu"`` is passed; the CLS token and
    the positions are N(0, 0.02), as in the JAX package."""

    def __init__(self, image_size=224, patch_size=16, hidden=384, layers=12,
                 heads=6, num_classes=1000, intermediate=None, dropout=0.0,
                 attn_dropout=0.0, remat=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(
                f"image_size {image_size} not divisible by patch_size "
                f"{patch_size}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.patch_size = patch_size
        self.remat = remat
        n_patches = (image_size // patch_size) ** 2
        intermediate = intermediate or 4 * hidden
        self.patch_embed = nn.Conv2d(3, hidden, patch_size,
                                     stride=patch_size, **kw)
        self.cls_token = nn.Parameter(
            0.02 * torch.randn((1, 1, hidden), **kw))
        self.pos_emb = nn.Parameter(
            0.02 * torch.randn((n_patches + 1, hidden), **kw))
        self.dropout = nn.Dropout(dropout)
        self.blocks = nn.ModuleList([
            VitBlock(hidden, heads, intermediate, dropout=dropout,
                     attn_dropout=attn_dropout, **kw)
            for _ in range(layers)])
        self.ln_f = FusedLayerNorm(hidden, **kw)
        self.head = nn.Linear(hidden, num_classes, **kw)

    def forward(self, x, generator=None):
        b = x.shape[0]
        p = self.patch_embed(x)                       # (B, E, H', W')
        e = p.shape[1]
        p = p.reshape(b, e, -1).transpose(1, 2)       # (B, N, E)
        cls = self.cls_token.to(p.dtype).expand(b, 1, e)
        x = torch.cat([cls, p], dim=1)                # (B, N + 1, E)
        pos = self.pos_emb.to(x.dtype)
        if pos.shape[0] != x.shape[1]:
            raise ValueError(
                f"ViT built for {pos.shape[0] - 1} patches, got "
                f"{x.shape[1] - 1} (input spatial size mismatch)")
        x = dropout(x + pos[None], self.dropout.p, self.training, generator)
        x = x.transpose(0, 1)                         # (S, B, E)
        for blk in self.blocks:
            x = checkpoint_forward(blk, x, generator) if self.remat \
                else blk(x, generator)
        return self.head(self.ln_f(x[0]))             # the CLS state


def vit_small(**kw):
    """ViT-S/16: 12 layers, hidden 384, 6 heads (~22M)."""
    return VitModel(**{**dict(hidden=384, layers=12, heads=6), **kw})


def vit_base(**kw):
    """ViT-B/16: 12 layers, hidden 768, 12 heads (~86M)."""
    return VitModel(**{**dict(hidden=768, layers=12, heads=12), **kw})
