"""Op annotation, the NVTX-marker analogue: the PyTorch counterpart of
``apex_tpu/pyprof/annotate.py``.

While recording is on, each op the port runs is recorded once a call, in
the JAX package's event schema (``seq``, ``op``, ``dir``, ``scope``,
``shapes``, ``dtypes``, ``tensors``, ``params``, ``callsite``), and, while
a ``torch.profiler`` session records, runs inside a ``pp<seq>_<op>``
``record_function`` range: the label that ``parse/trace.py`` joins the
card's kernels to, in place of the JAX package's ``jax.named_scope``.

What is recorded:

* the port's functional ops (``apex_tpu_torch.nn.functional``) and its fused
  ops (flash attention, the fused LayerNorm and RMSNorm, the xentropy and
  chunked losses), wrapped where they are defined and wherever another
  module of the port bound them by name;
* every other torch call (``torch.nn.functional`` calls the port's models
  make, ``torch`` functions and tensor methods) through a
  ``TorchFunctionMode`` entered while recording is on, as amp O1's cast
  policy sees them (``amp/policy.py``), named as the policy names them;
* each optimizer's ``step``, and the multi-tensor updates a fused train
  step runs (``ops.multi_tensor_adam`` etc.), as one
  ``optimizer.<Class>.step`` event with the parameters' element count.

Only the outermost op is recorded: the torch calls inside a recorded op
belong to it.  A module's forward pushes its class name onto the event's
``scope`` (global module hooks, installed only while recording is on).
``init()`` is idempotent; events accumulate in a thread-local log drained
by ``pyprof.capture()`` / ``save()``.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import os
import sys
import threading

import torch
from torch.overrides import TorchFunctionMode

_state = threading.local()
_installed = False
_install_lock = threading.Lock()

_PKG = __name__.rsplit(".", 2)[0]          # "apex_tpu_torch"


def _log():
    if not hasattr(_state, "events"):
        _state.events = []
        _state.enabled = False
        _state.scopes = []
        _state.depth = 0
        _state.active = None               # (mode, hook handles) while on
    return _state


def events():
    return _log().events


def enabled() -> bool:
    return getattr(_log(), "enabled", False)


def clear():
    _log().events.clear()


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_tensor(v):
    return isinstance(v, torch.Tensor)


def _shape_of(x):
    return list(x.shape) if _is_tensor(x) else None


def _jsonable(v):
    if isinstance(v, (int, float, bool, str)) or v is None:
        return v
    if isinstance(v, (tuple, list, torch.Size)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.dtype):
        return _dtype_name(v)
    return repr(v)


_SKIP_DIRS = (f"{os.sep}{_PKG}{os.sep}", f"{os.sep}torch{os.sep}")


def _callsite():
    """First stack frame outside the port and torch: the user line that
    issued the op."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            break
        fn = f.f_code.co_filename
        if not any(s in fn for s in _SKIP_DIRS) and "<" not in fn:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


def _effective_dtypes(op, dtypes):
    """Dtypes as the op will run them under the active amp cast policy
    (idempotent where the policy's mode already cast the arguments)."""
    from ..amp.policy import current_policy
    pol = current_policy()
    if pol is None or not pol.enabled:
        return dtypes
    cat = pol.category_of(op)
    floats = {"float16", "bfloat16", "float32", "float64"}
    if cat == "half":
        tgt = _dtype_name(pol.half_dtype)
        return [tgt if d in floats else d for d in dtypes]
    if cat == "float":
        return ["float32" if d in floats else d for d in dtypes]
    if cat in ("promote", "sequence"):
        present = [d for d in dtypes if d in floats]
        if present:
            widest = "float32" if len(set(present)) > 1 else present[0]
            return [widest if d in floats else d for d in dtypes]
    return dtypes


def _flat_items(args, kwargs):
    """Positional tensors of a list argument (``torch.cat``'s) count as
    operands, as the JAX tape lifts them."""
    items = []
    for i, a in enumerate(args):
        if isinstance(a, (list, tuple)) and a and all(map(_is_tensor, a)):
            items += [(f"arg{i}_{j}", t) for j, t in enumerate(a)]
        else:
            items.append((f"arg{i}", a))
    return items + list(kwargs.items())


def _record(op, sig, args, kwargs):
    """Append one event: args bound to the op's signature (so positional
    layer params land in ``params`` by name); tensors feed ``shapes`` and
    ``dtypes`` in signature order.  Returns the event's seq."""
    st = _log()
    shapes, dtypes, params, tensors = [], [], {}, {}
    items = None
    if sig is not None:
        try:
            items = sig.bind(*args, **kwargs).arguments.items()
        except TypeError:
            items = None
    if items is None:
        items = _flat_items(args, kwargs)
    for name, v in items:
        if _is_tensor(v):
            shapes.append(_shape_of(v))
            dtypes.append(_dtype_name(v.dtype))
            tensors[name] = {"shape": _shape_of(v),
                             "dtype": _dtype_name(v.dtype)}
        elif v is not None:
            params[name] = _jsonable(v)
    eff = _effective_dtypes(op, dtypes)
    if eff is not dtypes:
        for name, d in zip(tensors, eff):
            tensors[name]["dtype"] = d
    seq = len(st.events)
    st.events.append({
        "seq": seq,
        "op": op,
        "dir": "fwd",
        "scope": "/".join(st.scopes) if st.scopes else "",
        "shapes": shapes,
        "dtypes": eff,
        "tensors": tensors,
        "params": params,
        "callsite": _callsite(),
    })
    return seq


def _profiling() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


def _run_recorded(op, sig, fn, args, kwargs, out_shape=False):
    """Record ``op`` and run it one level down (nested ops unrecorded),
    inside its ``pp<seq>_<op>`` range while a profiler records."""
    st = _log()
    st.depth += 1
    try:
        seq = _record(op, sig, args, kwargs)
        cm = torch.profiler.record_function(f"pp{seq}_{op}") \
            if _profiling() else contextlib.nullcontext()
        with cm:
            out = fn(*args, **kwargs)
        if out_shape and _is_tensor(out):
            # the output sizes data-movement ops (a getitem of one row
            # moves the row, not the whole input)
            st.events[seq]["out_shape"] = _shape_of(out)
        return out
    finally:
        st.depth -= 1


def _wrap_fn(op_name, fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        st = _log()
        if not st.enabled or st.depth:
            return fn(*args, **kwargs)
        return _run_recorded(op_name, sig, fn, args, kwargs)
    wrapper.__wrapped_pyprof__ = fn
    return wrapper


# ---------------------------------------------------------------------------
# torch calls: a TorchFunctionMode while recording is on
# ---------------------------------------------------------------------------

#: torch callables never recorded: metadata reads, host conversions and
#: the calls that drive the backward (its work is the backward's)
_SKIP_NAMES = frozenset({
    "dim", "size", "numel", "stride", "data_ptr", "is_contiguous",
    "is_floating_point", "is_complex", "element_size", "storage_offset",
    "__len__", "__bool__", "__int__", "__float__", "__index__", "item",
    "tolist", "__format__", "__repr__", "__hash__", "__iter__",
    "__contains__", "untyped_storage", "get_device", "nelement",
    "backward", "grad", "requires_grad_", "detach", "detach_",
    "__reduce_ex__", "__deepcopy__", "__setstate__", "__array__",
    "_is_view", "is_leaf", "record_stream", "has_names", "__dlpack__"})
_ALIASES = {"view": "reshape", "__getitem__": "getitem", "permute":
            "transpose", "t": "transpose", "to": "astype", "float":
            "astype", "half": "astype", "bfloat16": "astype",
            "__add__": "add", "__radd__": "add", "__iadd__": "add",
            "__sub__": "sub", "__rsub__": "rsub", "__mul__": "mul",
            "__rmul__": "mul", "__truediv__": "div", "__rtruediv__": "rdiv",
            "__matmul__": "matmul", "__neg__": "neg", "__pow__": "pow"}


def _torch_op_name(func):
    from ..amp.policy import TORCH_OPS
    try:
        name = TORCH_OPS.get(func)
    except TypeError:               # an unhashable callable
        name = None
    if name is not None:
        return name
    raw = getattr(func, "__name__", None)
    if raw is None or raw == "__get__" or raw == "__set__" \
            or raw in _SKIP_NAMES:
        return None
    return _ALIASES.get(raw, raw.strip("_") or raw)


@functools.lru_cache(maxsize=1024)
def _signature(func):
    """``func``'s signature where Python can read one (cached a callable:
    torch's functions and methods live as long as the process)."""
    try:
        return inspect.signature(func)
    except (TypeError, ValueError):
        return None


def _has_tensor(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if _is_tensor(a) or (isinstance(a, (list, tuple))
                             and any(map(_is_tensor, a))):
            return True
    return False


def _non_default(sig, kwargs):
    """``kwargs`` without the keywords a torch function passes on at their
    defaults (``F.relu``'s ``inplace=False``), so that an event's
    ``params`` hold what the caller chose, as the JAX package's do."""
    if sig is None or not kwargs:
        return kwargs
    out = {}
    for k, v in kwargs.items():
        p = sig.parameters.get(k)
        try:
            same = p is not None and p.default is not inspect.Parameter.empty \
                and not _is_tensor(v) and v == p.default
        except (TypeError, RuntimeError):
            same = False
        if not same:
            out[k] = v
    return out


class _RecordMode(TorchFunctionMode):
    """Records each outermost torch call (the mode is off while a call is
    handled, so the calls inside it are not seen; inside a recorded port
    op the depth passes them through)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = _log()
        if not st.enabled or st.depth or func in (torch.autograd.grad,
                                                  torch.autograd.backward):
            return func(*args, **kwargs)
        name = _torch_op_name(func)
        if name is None or not _has_tensor(args, kwargs):
            # a factory call or a profiler/host call: no op on data
            return func(*args, **kwargs)
        sig = _signature(func)
        rec = _non_default(sig, kwargs)
        return _run_recorded(name, None, lambda *a, **k: func(*a, **kwargs),
                             args, rec, out_shape=True)


def _scope_pre(module, args):
    st = _log()
    if st.enabled:
        st.scopes.append(type(module).__name__)


def _scope_post(module, args, output):
    st = _log()
    if st.enabled and st.scopes:
        st.scopes.pop()


def set_enabled(flag: bool):
    """Turn recording on or off on this thread: on enters the recording
    mode and the global module hooks of the scopes, off leaves them."""
    st = _log()
    flag = bool(flag)
    if flag and st.active is None:
        mode = _RecordMode()
        mode.__enter__()
        reg = torch.nn.modules.module
        hooks = (reg.register_module_forward_pre_hook(_scope_pre),
                 reg.register_module_forward_hook(_scope_post))
        st.active = (mode, hooks)
        st.scopes = []
    elif not flag and st.active is not None:
        mode, hooks = st.active
        st.active = None
        for h in hooks:
            h.remove()
        mode.__exit__(None, None, None)
    st.enabled = flag


# ---------------------------------------------------------------------------
# installation
# ---------------------------------------------------------------------------

#: (defining module, name): the port's fused ops outside nn.functional
_FUSED = (
    ("contrib.multihead_attn.attn_funcs", "flash_attention"),
    ("normalization.fused_layer_norm", "fused_layer_norm_affine"),
    ("normalization.fused_layer_norm", "fused_layer_norm"),
    ("normalization.rms_norm", "fused_rms_norm_affine"),
    ("normalization.rms_norm", "fused_rms_norm"),
    ("contrib.xentropy.softmax_xentropy", "softmax_cross_entropy_loss"),
    ("contrib.xentropy.chunked", "chunked_lm_head_loss"),
)

#: the multi-tensor updates of the fused steps -> their optimizer's name
_MULTI_TENSOR = {"multi_tensor_adam": "FusedAdam",
                 "multi_tensor_sgd": "FusedSGD",
                 "multi_tensor_lamb": "FusedLAMB",
                 "multi_tensor_novograd": "FusedNovoGrad"}


def _rebind(originals):
    """Point every name that a loaded module of the port binds to one of
    ``originals`` (fn -> wrapper) at its wrapper."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == _PKG or name.startswith(_PKG + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            try:
                w = originals.get(val)
            except TypeError:
                continue
            if w is not None:
                setattr(mod, attr, w)


def _opt_event(name, numel):
    st = _log()
    seq = len(st.events)
    st.events.append({
        "seq": seq, "op": f"optimizer.{name}.step", "dir": "fwd",
        "scope": "", "shapes": [[int(numel)]], "dtypes": ["float32"],
        "tensors": {}, "params": {}, "callsite": _callsite()})
    return seq


def _run_opt(name, numel, fn, args, kwargs):
    st = _log()
    st.depth += 1
    try:
        seq = _opt_event(name, numel)
        cm = torch.profiler.record_function(f"pp{seq}_{name}.step") \
            if _profiling() else contextlib.nullcontext()
        with cm:
            return fn(*args, **kwargs)
    finally:
        st.depth -= 1


def _wrap_opt_step(name, step):
    @functools.wraps(step)
    def wrapper(self, *args, **kwargs):
        st = _log()
        if not st.enabled or st.depth:
            return step(self, *args, **kwargs)
        numel = sum(p.numel() for g in getattr(self, "param_groups", [])
                    for p in g["params"])
        return _run_opt(name, numel, step, (self,) + args, kwargs)
    wrapper.__wrapped_pyprof__ = step
    return wrapper


def _wrap_multi_tensor(name, fn):
    @functools.wraps(fn)
    def wrapper(noop_flag, tensor_lists, *args, **kwargs):
        st = _log()
        if not st.enabled or st.depth:
            return fn(noop_flag, tensor_lists, *args, **kwargs)
        numel = sum(t.numel() for t in tensor_lists[1])
        return _run_opt(name, numel, fn, (noop_flag, tensor_lists) + args,
                        kwargs)
    wrapper.__wrapped_pyprof__ = fn
    return wrapper


def _install():
    from .. import ops, optimizers
    from ..nn import functional as F
    originals = {}
    for name, fn in list(vars(F).items()):
        if callable(fn) and not name.startswith("_") and \
                inspect.isfunction(fn) and fn.__module__ == F.__name__:
            originals[fn] = _wrap_fn(name, fn)
    for modname, name in _FUSED:
        mod = importlib.import_module(f"{_PKG}.{modname}")
        fn = getattr(mod, name)
        if not hasattr(fn, "__wrapped_pyprof__"):
            originals[fn] = _wrap_fn(name, fn)
    for name, opt in _MULTI_TENSOR.items():
        fn = getattr(ops, name)
        if not hasattr(fn, "__wrapped_pyprof__"):
            originals[fn] = _wrap_multi_tensor(opt, fn)
    _rebind(originals)
    for cls in vars(optimizers).values():
        if inspect.isclass(cls) and issubclass(cls, torch.optim.Optimizer) \
                and "step" in vars(cls) \
                and not hasattr(cls.step, "__wrapped_pyprof__"):
            cls.step = _wrap_opt_step(cls.__name__, cls.step)


def init():
    """Install the annotator (idempotent) and enable recording: the
    ``pyprof.nvtx.init()`` analogue."""
    global _installed
    with _install_lock:
        if not _installed:
            _install()
            _installed = True
    set_enabled(True)
