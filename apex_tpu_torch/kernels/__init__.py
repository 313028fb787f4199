"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the device rule that picks between them
(:mod:`.dispatch`)."""
from .attention import (flash_attention_bwd, flash_attention_bwd_reference,
                        flash_attention_fwd, flash_attention_reference)
from .dispatch import MASKED_FILL, MASKED_LOGIT_THR, counts, reset_counts
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
           "xent_forward_reference"]
