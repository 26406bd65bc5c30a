"""Checkpointing for the PyTorch port: :class:`CheckpointManager`
writes atomic, rotated snapshots of tensor trees and of an
``HDArrayRuntime``'s arrays."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
