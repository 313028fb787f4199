"""Counterpart of ``apex_tpu/contrib/xentropy``: the label-smoothed softmax
cross-entropy over the hand-written xentropy kernels, and the chunked
LM-head loss built on it."""
from .chunked import chunked_lm_head_loss, make_chunked_lm_loss
from .softmax_xentropy import (SoftmaxCrossEntropyLoss,
                               softmax_cross_entropy_loss)

__all__ = ["SoftmaxCrossEntropyLoss", "chunked_lm_head_loss",
           "make_chunked_lm_loss", "softmax_cross_entropy_loss"]
