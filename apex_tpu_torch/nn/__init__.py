from . import functional
from .modules import checkpoint_forward, to_channels_last

__all__ = ["checkpoint_forward", "functional", "to_channels_last"]
