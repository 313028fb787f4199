"""Mesh axis names as process groups: the port's one addition to the JAX
surface of ``parallel/``.

The JAX package names mesh axes inside ``shard_map`` (``lax.psum(x,
"model")``, ``lax.axis_index("sp")``) under a mesh the caller entered.  The
port runs one process per rank on ``torch.distributed``, and its callables
keep the JAX keywords (``tp_axis="model"``, ``axis_name=("data", "sp")``).
This module turns such a name, or a tuple of names, into a process group,
its size and this rank's index on it:

- :func:`use_mesh` enters a ``torch.distributed`` ``DeviceMesh`` with named
  dims (``init_device_mesh(device, (2, 2), mesh_dim_names=("data",
  "model"))``), the counterpart of entering a JAX mesh; contexts nest, the
  innermost wins.
- :func:`resolve` looks a name up: one dim of the entered mesh is
  ``mesh.get_group(name)``; a tuple of dims is the group of their product
  (the ranks that share every other dim's coordinate), made once for each
  mesh and tuple with ``new_group`` on every rank (it is collective) and
  cached.  This rank's index on a tuple is row-major in the tuple's order,
  as ``lax.axis_index`` of a tuple is.
- Without a mesh, ``"data"`` alone (or ``("data",)``) is
  ``torch.distributed``'s default group, as in the data-parallel step; with
  no process group at all it is a world of this one process.  Any other
  name raises: an axis that no mesh names is never taken as a world of one.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch.distributed as dist

from .._unported import refuse

_MESHES = []
_GROUPS = {}


class Axis(NamedTuple):
    """A resolved axis: the process group (None: the default group, or no
    group at all when ``size`` is 1 without ``torch.distributed``), the
    number of ranks on it and this rank's index."""
    group: Optional[object]
    size: int
    index: int


@contextlib.contextmanager
def use_mesh(mesh):
    """Enter ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``) as the mesh
    whose dims name the axes of everything called inside."""
    if not getattr(mesh, "mesh_dim_names", None):
        raise ValueError("use_mesh needs a DeviceMesh with mesh_dim_names")
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost entered mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def names_of(axis) -> tuple:
    """``axis`` (a name or a tuple or list of names) as a tuple of names."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _product_group(mesh, names):
    """The group of the product of ``names``' dims of ``mesh`` holding this
    rank, and its index there (row-major over ``names``)."""
    dims = list(mesh.mesh_dim_names)
    key = (id(mesh), names)
    if key not in _GROUPS:
        ranks = mesh.mesh
        axes = [dims.index(n) for n in names]
        rest = [i for i in range(len(dims)) if i not in axes]
        k = 1
        for a in axes:
            k *= ranks.shape[a]
        blocks = ranks.permute(*rest, *axes).reshape(-1, k)
        me, mine = dist.get_rank(), None
        for block in blocks:
            members = [int(r) for r in block]
            # every rank makes every group, in the same order
            g = dist.new_group(sorted(members))
            if me in members:
                mine = (g, len(members), members.index(me))
        _GROUPS[key] = mine
    return _GROUPS[key]


def resolve(axis, what="mesh axis") -> Axis:
    """The process group, size and this rank's index of ``axis``;
    ``what`` names the argument in the refusal of an axis no mesh
    names."""
    names = names_of(axis)
    mesh = current_mesh()
    if mesh is not None and all(n in mesh.mesh_dim_names for n in names):
        if len(names) == 1:
            g = mesh.get_group(names[0])
            return Axis(g, dist.get_world_size(g), dist.get_rank(g))
        g, size, index = _product_group(mesh, names)
        return Axis(g, size, index)
    if names == ("data",):
        if not dist.is_available() or not dist.is_initialized():
            return Axis(None, 1, 0)
        return Axis(None, dist.get_world_size(), dist.get_rank())
    named = () if mesh is None else tuple(mesh.mesh_dim_names)
    # the planner (parallel="auto") is what builds a mesh implicitly in the
    # JAX package
    refuse(f"{what} {axis!r}: no entered mesh names it (axes {named}); "
           f"enter parallel.use_mesh(DeviceMesh) with these dims, since "
           f"building a mesh implicitly", "ROADMAP A9, the planner")


def global_rank(ax: Axis, index: int) -> int:
    """The global rank of ``ax``'s rank ``index`` (a point-to-point peer)."""
    if ax.group is None:
        return index
    return dist.get_global_rank(ax.group, index)


def reset():
    """Forget the cached product groups (after a process group is torn
    down)."""
    _GROUPS.clear()


__all__ = ["Axis", "current_mesh", "global_rank", "names_of", "reset",
           "resolve", "use_mesh"]
