"""Matrix products that are pure functions of their operands' values, for
tests that compare two separately computed CPU results bit for bit.

A CPU BLAS is not promised to give the same bits for the same values twice:
the same operands at another address or under another thread split may be
summed in another order.  Inside :func:`value_products`, every product and
convolution that reaches the dispatcher (forward and backward alike) is
computed as usual and then overwritten with the result of the first call
that saw the same operand values, so two computations that multiply the
same values take the same bits, and two that multiply different values
still differ.  The rest of the arithmetic (softmax, reductions, casts) is
torch's own; inside :func:`value_ops` it is memoised too.
"""
import contextlib
import hashlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

aten = torch.ops.aten

PRODUCTS = {
    aten.mm.default, aten.bmm.default, aten.addmm.default,
    aten.baddbmm.default, aten.addbmm.default, aten.mv.default,
    aten.addmv.default, aten.dot.default, aten.convolution.default,
    aten.convolution_backward.default, aten._convolution.default,
}


def _key_of(x):
    """A tensor by its shape, dtype and bytes; anything else as it is."""
    if not isinstance(x, torch.Tensor):
        return x if isinstance(x, (int, float, bool, str, type(None))) \
            else repr(x)
    flat = x.detach().contiguous().reshape(-1)
    digest = hashlib.sha1(flat.view(torch.uint8).numpy().tobytes()
                          if flat.numel() else b"").hexdigest()
    return (tuple(x.shape), x.dtype, digest)


def _memoisable(func, leaves, out):
    """Whether ``func``'s result may be replaced by a memo: any op whose
    outputs are fresh floating tensors (not views of its inputs) and that
    draws no random numbers."""
    if torch.Tag.nondeterministic_seeded in func.tags:
        return False
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if not outs or not all(t.is_floating_point() for t in outs):
        return False
    held = {t.untyped_storage().data_ptr() for t in leaves
            if isinstance(t, torch.Tensor)}
    return not any(t.untyped_storage().data_ptr() in held for t in outs)


class _ValueProducts(TorchDispatchMode):
    def __init__(self, every_op=False):
        super().__init__()
        self.memo = {}
        self.every_op = every_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        leaves, _ = tree_flatten((args, kwargs))
        if func not in PRODUCTS and not (
                self.every_op and _memoisable(func, leaves, out)):
            return out
        key = (str(func),) + tuple(_key_of(x) for x in leaves)
        first = self.memo.get(key)
        if first is None:
            self.memo[key] = tree_map(
                lambda t: t.detach().clone()
                if isinstance(t, torch.Tensor) else t, out)
            return out
        got, _ = tree_flatten(out)
        want, _ = tree_flatten(first)
        with torch.no_grad():
            for g, w in zip(got, want):
                if isinstance(g, torch.Tensor):
                    g.copy_(w)
        return out


@contextlib.contextmanager
def value_products():
    """The scope in which CPU products are memoised on their operands'
    values (see the module docstring)."""
    with _ValueProducts():
        yield


@contextlib.contextmanager
def value_ops():
    """The scope in which every CPU op that makes fresh floating tensors
    and draws no random numbers (products, reductions, ``exp``,
    ``logsumexp``, softmax, ...) is memoised on its operands' values, so
    that two computations that apply the same ops to the same values take
    the same bits at every op, and two that differ in an op or an operand
    still differ."""
    with _ValueProducts(every_op=True):
        yield
