"""Refusals of what the port does not run yet.

The port's callables take every keyword argument of their JAX twins, under
the same names and defaults.  A value that asks for something not ported
(a mesh axis, tensor or sequence parallelism, experts) raises
``NotImplementedError`` naming the ROADMAP item that owns it.
"""
from __future__ import annotations

PARALLEL = "ROADMAP A9, parallelism beyond single-process DP"


def refuse(what, owner):
    raise NotImplementedError(f"{what} is not ported yet ({owner})")


def accept_defaults(what, owner, **args):
    """Each keyword is ``(value, default)``; any value other than its
    default is refused as ``what (names)``, naming ``owner``."""
    bad = [name for name, (value, default) in args.items()
           if value != default]
    if bad:
        refuse(f"{what} ({', '.join(bad)})", owner)
