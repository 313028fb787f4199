"""Dispatcher mirroring ``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``.

Kept for API parity only; it carries no behaviour.  The reference hands a
chunk size, an overflow buffer and tensor lists to a CUDA op; here the ops
are the functions of :mod:`apex_tpu_torch.ops`, whose kernels cut the lists
into chunks of their own, so the constructor's ``chunk_size`` is accepted
and ignored, and a call is ``op(noop_flag, tensor_lists, *args)``.  The
port's optimizers call the ops directly.
"""


class MultiTensorApply:
    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        del chunk_size

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args, **kwargs):
        return op(noop_flag_buffer, tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply(2048 * 32)
