from . import functional
from .modules import to_channels_last

__all__ = ["functional", "to_channels_last"]
