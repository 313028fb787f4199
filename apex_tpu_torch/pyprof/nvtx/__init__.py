"""Reference-API shim: ``pyprof.nvtx.init()`` (apex/pyprof/nvtx/nvmarker.py),
the port's copy of ``apex_tpu/pyprof/nvtx/__init__.py``.

The "marker" is the op annotator (see ..annotate), whose ``pp<seq>_<op>``
profiler ranges the parse stage joins the card's kernels to.

``nvtx.annotate("region")``, the reference's range-marker context manager,
goes through :func:`apex_tpu_torch.observe.span`: one span surface feeds
the structured event log, an NVTX range on the card and a
``torch.profiler`` range while one records.
"""
from ..annotate import clear, events, init, set_enabled  # noqa: F401


def annotate(name: str, **fields):
    """Range marker context manager: ``with nvtx.annotate("fwd"): ...``,
    an ``observe.span`` (host-side only)."""
    from ...observe import span as _span
    return _span(name, **fields)


__all__ = ["init", "set_enabled", "events", "clear", "annotate"]
