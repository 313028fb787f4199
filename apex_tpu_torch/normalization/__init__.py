from .fused_layer_norm import (FusedLayerNorm, fused_layer_norm,
                               fused_layer_norm_affine)
from .rms_norm import FusedRMSNorm, fused_rms_norm, fused_rms_norm_affine

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "fused_layer_norm",
           "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine"]
