"""Refusals of what the port does not run yet.

The port's callables take every keyword argument of their JAX twins, under
the same names and defaults.  A value that asks for something not ported
(sharded decode, experts, the planner) raises ``NotImplementedError``
naming the ROADMAP item that owns it.
"""
from __future__ import annotations

#: what A9's third part owns: the planner (``parallel/auto.py``), JAX mesh
#: objects and axes the port's process groups do not take
PARALLEL = "ROADMAP A9, the planner and JAX meshes"
#: A9's second part, what is left of it after tensor and sequence
#: parallelism in training
DECODE_MESH = "ROADMAP A9, second part: decode under a mesh"
EXPERTS = "ROADMAP A9, second part: experts"


def refuse(what, owner):
    raise NotImplementedError(f"{what} is not ported yet ({owner})")


def accept_defaults(what, owner, **args):
    """Each keyword is ``(value, default)``; any value other than its
    default is refused as ``what (names)``, naming ``owner``."""
    bad = [name for name, (value, default) in args.items()
           if value != default]
    if bad:
        refuse(f"{what} ({', '.join(bad)})", owner)
