"""The DCGAN networks of ``examples/dcgan/main_amp.py`` in ``torch.nn``,
with the same layers in the same order, so that the JAX example's state
dict names (``0.weight``, ``1.running_mean``, ...) carry across.

The generator maps ``(B, nz, 1, 1)`` noise through four transposed
convolutions (4x4 -> 8x8 -> 16x16 -> 32x32) to ``(B, 3, 32, 32)`` images in
[-1, 1]; the discriminator maps such images through four convolutions to
one logit an image, ``(B,)``.  Built on the card unless ``device="cpu"``
is passed; torch's default initialisation, from its global generator.
"""
from __future__ import annotations

from torch import nn

from ..kernels.dispatch import resolve_device


def build_generator(nz, ngf, device=None):
    return nn.Sequential(
        nn.ConvTranspose2d(nz, ngf * 4, 4, stride=1, padding=0),
        nn.BatchNorm2d(ngf * 4), nn.ReLU(),
        nn.ConvTranspose2d(ngf * 4, ngf * 2, 4, stride=2, padding=1),
        nn.BatchNorm2d(ngf * 2), nn.ReLU(),
        nn.ConvTranspose2d(ngf * 2, ngf, 4, stride=2, padding=1),
        nn.BatchNorm2d(ngf), nn.ReLU(),
        nn.ConvTranspose2d(ngf, 3, 4, stride=2, padding=1),
        nn.Tanh()).to(resolve_device(device))


def build_discriminator(ndf, device=None):
    return nn.Sequential(
        nn.Conv2d(3, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2),
        nn.Conv2d(ndf, ndf * 2, 4, stride=2, padding=1),
        nn.BatchNorm2d(ndf * 2), nn.LeakyReLU(0.2),
        nn.Conv2d(ndf * 2, ndf * 4, 4, stride=2, padding=1),
        nn.BatchNorm2d(ndf * 4), nn.LeakyReLU(0.2),
        nn.Conv2d(ndf * 4, 1, 4, stride=1, padding=0),
        nn.Flatten(0)).to(resolve_device(device))
