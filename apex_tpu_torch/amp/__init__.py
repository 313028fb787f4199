"""Mixed precision.  So far the loss scaler; ``initialize`` and
``scale_loss`` (O0-O3) come with slice 3."""
from .scaler import (LossScaler, ScalerState, init_scaler_state,
                     update_scale_state)

__all__ = ["LossScaler", "ScalerState", "init_scaler_state",
           "update_scale_state"]
