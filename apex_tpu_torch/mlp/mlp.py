"""The fused MLP, the PyTorch counterpart of ``apex_tpu/mlp/mlp.py`` (the
reference's ``apex.mlp.MLP`` over its ``mlp_cuda`` extension).

The reference fuses N cuBLAS GEMMs with their bias and ReLU epilogues; the
JAX package computes the chain as plain matmuls outside any Pallas
kernel, and so does the port (``F.linear`` + ReLU a layer).  What is kept
is the API (the flat ``weight_i`` / ``bias_i`` attributes, the
reference's initial distributions, ``bias`` and ``relu`` both required),
the numerics (ReLU after every layer, the last one included) and amp O1's
treatment of ``mlp_function`` as one half-precision op (the ``"mlp"``
entry of ``FP16_FUNCS``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..amp.policy import policied
from ..kernels.dispatch import resolve_device


@policied("mlp")
def mlp_function(x, *weights_and_biases):
    """Linear + bias + ReLU a layer over the flat ``(w_0 .. w_{N-1}, b_0
    .. b_{N-1})`` arguments; under amp O1 every argument is cast to the
    half dtype first, as for one fp16 op."""
    num_layers = len(weights_and_biases) // 2
    weights = weights_and_biases[:num_layers]
    biases = weights_and_biases[num_layers:]
    for w, b in zip(weights, biases):
        x = F.relu(F.linear(x, w, b))
    return x


class MLP(nn.Module):
    """A chain of Linear + bias + ReLU layers.

    ``mlp_sizes`` such as ``[480, 1024, 1024, 1]`` gives 3 layers;
    ``bias`` and ``relu`` must both be True, as in the reference."""

    def __init__(self, mlp_sizes, bias=True, relu=True, device=None,
                 dtype=torch.float32):
        if not (bias and relu):
            raise TypeError("bias and relu must be both true.")
        super().__init__()
        self.num_layers = len(mlp_sizes) - 1
        self.mlp_sizes = list(mlp_sizes)
        self.bias, self.relu = bias, relu
        kw = dict(device=resolve_device(device), dtype=dtype)
        for i in range(self.num_layers):
            self.register_parameter(f"weight_{i}", nn.Parameter(
                torch.empty(mlp_sizes[i + 1], mlp_sizes[i], **kw)))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.empty(mlp_sizes[i + 1], **kw)))
        self.reset_parameters()

    @property
    def weights(self):
        return [getattr(self, f"weight_{i}") for i in range(self.num_layers)]

    @property
    def biases(self):
        return [getattr(self, f"bias_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self):
        # the reference's distributions
        for w in self.weights:
            nn.init.normal_(w, 0.0, math.sqrt(2.0 / float(w.shape[0]
                                                          + w.shape[1])))
        for b in self.biases:
            nn.init.normal_(b, 0.0, math.sqrt(1.0 / float(b.shape[0])))

    def forward(self, x):
        return mlp_function(x, *self.weights, *self.biases)

    def extra_repr(self):
        return (f"MLP sizes: {self.mlp_sizes}, Bias={self.bias}, "
                f"ReLU={self.relu}")
