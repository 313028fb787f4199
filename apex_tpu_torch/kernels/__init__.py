"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, the device rule that picks between them and the tier decision
over the measured ledger (:mod:`.dispatch`, :mod:`.ledger`).  Each kernel
module registers its kernels with :mod:`.dispatch` on import."""
from . import ledger  # noqa: F401
from . import dispatch  # noqa: F401
from .attention import (flash_attention_bwd, flash_attention_bwd_reference,
                        flash_attention_fwd, flash_attention_reference)
from .dispatch import (MASKED_FILL, MASKED_LOGIT_THR, Decision, KernelSpec,
                       attention_fp, catalog, counts, decide, decisions,
                       measured_threshold, multi_tensor_fp, parse_fp,
                       register_kernel, reset_counts, reset_decisions,
                       shape_fp, vocab_chain_fp)
from .ledger import Ledger, chip_name, get_ledger
from .ledger import set_path as set_ledger_path
from .layer_norm import (ln_backward, ln_backward_reference, ln_forward,
                         ln_forward_reference)
from .lm_head_xent import (fused_lm_head_xent, lm_head_xent_backward,
                           lm_head_xent_backward_reference,
                           lm_head_xent_forward,
                           lm_head_xent_forward_reference)
from .multi_tensor import fused_adam, fused_adam_reference
from .rms_norm import (rms_backward, rms_backward_reference, rms_forward,
                       rms_forward_reference)
from .vocab_chain import vocab_chain_loss
from . import spec_verify  # noqa: F401
from .xentropy import (xent_backward, xent_backward_reference, xent_forward,
                       xent_forward_reference)

__all__ = ["flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_reference", "fused_adam",
           "fused_adam_reference", "fused_lm_head_xent",
           "lm_head_xent_backward", "lm_head_xent_backward_reference",
           "lm_head_xent_forward", "lm_head_xent_forward_reference",
           "ln_backward", "ln_backward_reference", "ln_forward",
           "ln_forward_reference", "MASKED_FILL", "MASKED_LOGIT_THR",
           "counts", "reset_counts", "rms_backward", "rms_backward_reference",
           "rms_forward", "rms_forward_reference", "vocab_chain_loss",
           "xent_backward", "xent_backward_reference", "xent_forward",
           "xent_forward_reference", "Decision", "KernelSpec", "Ledger",
           "attention_fp", "catalog", "chip_name", "decide", "decisions",
           "get_ledger", "measured_threshold", "multi_tensor_fp", "parse_fp",
           "register_kernel", "reset_decisions", "set_ledger_path",
           "shape_fp", "vocab_chain_fp", "ledger", "dispatch",
           "spec_verify"]
