"""O1's per-op cast policy, the PyTorch counterpart of
``apex_tpu/amp/policy.py``.

A ``CastPolicy`` decides, for an op named in the JAX package's vocabulary
(``amp/lists``), what its floating arguments are cast to: ops on the half
list to the policy's half dtype, ops on the float list to fp32, promote and
sequence ops to the widest float type among their arguments; a banned op
raises unless ``allow_banned``.  Integer and boolean tensors, and anything
that is not a tensor, are never touched.  The active policy is the top of
a stack (``autocast``; ``disable_casts`` pushes None).

The JAX package consults the policy in its own functional ops and tape
operators.  The port reaches torch's ops through a
``torch.overrides.TorchFunctionMode`` (``_CastMode``): every torch
callable in ``TORCH_OPS`` (``F.conv2d``, ``F.linear``, ``F.batch_norm``,
``torch.add``, ``Tensor.__add__``, ``torch.cat``, ...) is mapped to its
JAX op name and cast through :func:`apply_op_policy`; every other callable,
in-place ones included (``add_``, ``__iadd__``), runs as it is.  The mode
is entered only inside a scope: an ``autocast`` block, or a module call
while an O1 session is on.  For the latter, ``install_module_hooks`` adds
one global forward pre-hook and one forward hook (called on every exit,
exceptions included) that scope the outermost module call of a nest the
way the JAX tape scopes a module call (``apex_tpu/autograd.py:318-345``):
the module's own ``_amp_policy``, else the session's ambient policy unless
the module has O2's input cast, and none at all inside ``disable_casts``.
Ops outside any module call, such as the loss scaling and the optimizer
step, are not cast.  A module whose class sets ``_amp_no_casts`` (the
fused norms and attention, which are one op in the JAX package) runs its
body with casts off, and so does a function wrapped by :func:`no_casts`.

The registry API (``register_*_function``, ``half_function``,
``float_function``, ``promote_function``) wraps callables on any Python
module with casts driven by the active policy, as the JAX package's does.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import lists
from ._amp_state import _amp_state, maybe_print

_f32 = torch.float32
_WIDTH = {torch.float16: 0, torch.bfloat16: 0, torch.float32: 1,
          torch.float64: 2}


def _float_leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            out.append(tree)
    elif type(tree) in (tuple, list):
        for x in tree:
            _float_leaves(x, out)
    elif type(tree) is dict:
        for x in tree.values():
            _float_leaves(x, out)
    return out


def _cast_tree(tree, dtype):
    """``tree`` with every floating tensor not already ``dtype`` cast to it
    (a tensor of that dtype is passed through, not copied)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and tree.dtype != dtype:
            return tree.to(dtype)
        return tree
    if type(tree) in (tuple, list):
        return type(tree)(_cast_tree(x, dtype) for x in tree)
    if type(tree) is dict:
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree


def widest_float_dtype(tree):
    """The widest float dtype among the floating tensors of ``tree`` (one
    half dtype stays itself, fp16 with bf16 promotes to fp32, anything
    with fp32 or fp64 to the widest); None without floating tensors."""
    dtypes = {x.dtype for x in _float_leaves(tree, [])}
    if not dtypes:
        return None
    if len(dtypes) == 1:
        return next(iter(dtypes))
    width = max(_WIDTH.get(d, 1) for d in dtypes)
    if width == 0:
        return _f32
    return torch.float64 if width == 2 else _f32


class CastPolicy:
    """The cast configuration of one amp session."""

    def __init__(self, half_dtype=torch.float16, enabled: bool = True,
                 allow_banned: bool = False, verbose: bool = False):
        from .frontend import resolve_dtype
        self.half_dtype = resolve_dtype(half_dtype)
        self.enabled = enabled
        self.allow_banned = allow_banned
        self.verbose = verbose
        self.user_half = set()
        self.user_float = set()
        self.user_promote = set()

    def category_of(self, op_name: str) -> Optional[str]:
        """"half", "float", "promote", "sequence", "banned" or None."""
        if op_name in self.user_half:
            return "half"
        if op_name in self.user_float:
            return "float"
        if op_name in self.user_promote:
            return "promote"
        for name, _msg in lists.BANNED_FUNCS:
            if op_name == name:
                return "banned"
        if op_name in lists.FP16_FUNCS:
            return "half"
        if op_name in lists.FP32_FUNCS:
            return "float"
        if op_name in lists.CASTS:
            return "promote"
        if op_name in lists.SEQUENCE_CASTS:
            return "sequence"
        return None

    def cast_args(self, op_name: str, args, kwargs=None):
        """This policy's cast for ``op_name`` applied to (args, kwargs)."""
        kwargs = {} if kwargs is None else kwargs
        cat = self.category_of(op_name)
        if cat is None:
            return args, kwargs
        if cat == "banned":
            if not self.allow_banned:
                raise NotImplementedError(dict(lists.BANNED_FUNCS)[op_name])
            return args, kwargs
        if cat == "half":
            dtype = self.half_dtype
        elif cat == "float":
            dtype = _f32
        else:
            dtype = widest_float_dtype((args, kwargs))
            if dtype is None:
                return args, kwargs
        if self.verbose:
            maybe_print(f"amp: casting args of {op_name} to "
                        f"{str(dtype).replace('torch.', '')}")
        return _cast_tree(args, dtype), _cast_tree(kwargs, dtype)


# ---------------------------------------------------------------------------
# The active-policy stack and the torch-function mode that applies it
# ---------------------------------------------------------------------------

_policy_stack: list = []


def current_policy() -> Optional[CastPolicy]:
    """The innermost active policy, or None when casts are disabled."""
    return _policy_stack[-1] if _policy_stack else None


def casts_disabled() -> bool:
    """True inside an explicit ``disable_casts`` scope (the stack's top is
    None), unlike an empty stack (no scope at all)."""
    return bool(_policy_stack) and _policy_stack[-1] is None


def apply_op_policy(op_name: str, args, kwargs=None):
    """Cast (args, kwargs) of ``op_name`` by the active policy."""
    pol = current_policy()
    if pol is None or not pol.enabled:
        return args, ({} if kwargs is None else kwargs)
    return pol.cast_args(op_name, args, kwargs)


def _torch_ops():
    """torch callable -> JAX op name, for every op the lists name: the
    ``torch.nn.functional``, ``torch`` and ``Tensor`` callables of that
    name, and the operators the JAX tape maps (``autograd.py:176-185``)."""
    table = {}

    def add(fn, name):
        if fn is not None:
            table[fn] = name

    names = (lists.FP16_FUNCS + lists.FP32_FUNCS + lists.CASTS
             + lists.SEQUENCE_CASTS + [n for n, _ in lists.BANNED_FUNCS])
    for name in names:
        for owner in (F, torch, torch.Tensor):
            add(getattr(owner, name, None), name)
    T = torch.Tensor
    for name, fns in (
            ("add", (T.__add__, T.__radd__)),
            ("mul", (T.__mul__, T.__rmul__)),
            ("div", (T.__truediv__, torch.true_divide, T.true_divide,
                     torch.divide, T.divide)),
            ("matmul", (T.__matmul__,)),
            ("pow", (T.__pow__,)),
            ("eq", (T.__eq__,)), ("ne", (T.__ne__,)), ("lt", (T.__lt__,)),
            ("le", (T.__le__,)), ("gt", (T.__gt__,)), ("ge", (T.__ge__,)),
            ("cat", (torch.concat,))):
        for fn in fns:
            add(fn, name)
    return table


#: torch callable -> the op name the policy is asked about
TORCH_OPS = _torch_ops()


class _CastMode(TorchFunctionMode):
    """Casts the arguments of every ``TORCH_OPS`` callable by the active
    policy.  While a call is handled the mode is off, so the ops inside
    one callable (``F.cross_entropy``'s ``log_softmax``) are not cast
    again."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        try:
            name = TORCH_OPS.get(func)
        except TypeError:           # an unhashable callable
            name = None
        if name is not None:
            args, kwargs = apply_op_policy(name, args, kwargs)
        return func(*args, **(kwargs or {}))


_mode = []          # the entered _CastMode, while one is


def _enter(policy):
    """Push ``policy`` (None disables casts) and enter the mode if a
    policy needs it and none is entered; returns what :func:`_leave`
    undoes."""
    _policy_stack.append(policy)
    if policy is None or _mode:
        return False
    mode = _CastMode()
    mode.__enter__()
    _mode.append(mode)
    return True


def _leave(entered):
    try:
        if entered:
            _mode.pop().__exit__(None, None, None)
    finally:
        _policy_stack.pop()


@contextlib.contextmanager
def autocast(policy: Optional[CastPolicy]):
    """Make ``policy`` the active one for the block; torch ops called in
    it are cast.  ``autocast(None)`` is ``disable_casts``."""
    entered = _enter(policy)
    try:
        yield policy
    finally:
        _leave(entered)


disable_casts = functools.partial(autocast, None)


def no_casts(fn):
    """Run ``fn`` with casts off: for the bodies of the port's fused ops,
    which the JAX package runs as one op that no policy sees."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _mode:
            return fn(*args, **kwargs)
        with disable_casts():
            return fn(*args, **kwargs)
    return wrapper


def policied(op_name: str):
    """Decorator for the port's counterpart of a JAX functional op: its
    arguments are cast by the active policy as ``op_name``'s, and its
    body runs with casts off, as the JAX op's body is plain jnp."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            args, kwargs = apply_op_policy(op_name, args, kwargs)
            if not _mode:
                return fn(*args, **kwargs)
            with disable_casts():
                return fn(*args, **kwargs)
        wrapper._op_name = op_name
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Module-call scoping for an O1 session
# ---------------------------------------------------------------------------

# one per module call in progress: None, or what _enter returned for it
_frames: list = []
_hooks: list = []


def _module_policy(module):
    """The policy a module call runs under, as the JAX tape picks it: the
    module's own ``_amp_policy``, else the session's ambient policy
    unless the module has O2's input cast; none inside ``disable_casts``."""
    pol = getattr(module, "_amp_policy", None)
    if pol is None and getattr(module, "_amp_input_cast_dtype", None) is None:
        pol = _amp_state.ambient_policy
    if pol is not None and casts_disabled():
        pol = None
    return pol


def _pre_hook(module, args):
    if getattr(module, "_amp_no_casts", False):
        _frames.append(_enter(None))
        return
    if _frames:
        # inside a module call: the outermost call of the nest picked the
        # policy, as a module's forward calls its children in the JAX tape
        _frames.append(None)
        return
    pol = _module_policy(module)
    _frames.append(None if pol is None else _enter(pol))


def _post_hook(module, args, output):
    entered = _frames.pop()
    if entered is not None:
        _leave(entered)


def install_module_hooks():
    """Scope every module call by :func:`_module_policy` (idempotent)."""
    if _hooks:
        return
    mod = torch.nn.modules.module
    _hooks.append(mod.register_module_forward_pre_hook(_pre_hook))
    _hooks.append(mod.register_module_forward_hook(_post_hook,
                                                   always_call=True))


def remove_module_hooks():
    while _hooks:
        _hooks.pop().remove()


# ---------------------------------------------------------------------------
# User registry and decorators
# ---------------------------------------------------------------------------

def _wrapped(fn, op_name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = apply_op_policy(op_name, args, kwargs)
        return fn(*args, **kwargs)
    wrapper._amp_registered = op_name
    return wrapper


# registrations made before amp.initialize() creates the session's policy
# are replayed onto it
_pending_registrations: list = []


def _register(user_set_name: str, module, name: str):
    for pol in _policy_stack:
        if pol is not None:
            getattr(pol, user_set_name).add(name)
    _pending_registrations.append((user_set_name, name))
    setattr(module, name, _wrapped(getattr(module, name), name))


def replay_registrations(policy: CastPolicy):
    for user_set_name, name in _pending_registrations:
        getattr(policy, user_set_name).add(name)


def register_half_function(module, name):
    _register("user_half", module, name)


def register_float_function(module, name):
    _register("user_float", module, name)


def register_promote_function(module, name):
    _register("user_promote", module, name)


def _active():
    pol = current_policy()
    return pol if pol is not None and pol.enabled else None


def half_function(fn):
    """Decorator: run ``fn`` with its float arguments in the active
    policy's half dtype."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        pol = _active()
        if pol is not None:
            args = _cast_tree(args, pol.half_dtype)
            kwargs = _cast_tree(kwargs, pol.half_dtype)
        return fn(*args, **kwargs)
    return wrapper


def float_function(fn):
    """Decorator: run ``fn`` with its float arguments in fp32 while a
    policy is active."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _active() is not None:
            args = _cast_tree(args, _f32)
            kwargs = _cast_tree(kwargs, _f32)
        return fn(*args, **kwargs)
    return wrapper


def promote_function(fn):
    """Decorator: run ``fn`` with its float arguments in their widest
    dtype while a policy is active."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _active() is not None:
            dtype = widest_float_dtype((args, kwargs))
            if dtype is not None:
                args = _cast_tree(args, dtype)
                kwargs = _cast_tree(kwargs, dtype)
        return fn(*args, **kwargs)
    return wrapper
