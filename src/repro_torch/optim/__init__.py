"""The optimizer of the port: AdamW (``adamw``)."""
from . import adamw
from .adamw import AdamWConfig, OptState

__all__ = ["adamw", "AdamWConfig", "OptState"]
