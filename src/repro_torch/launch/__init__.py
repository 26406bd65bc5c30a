"""Launchers of the port: ``serve`` (the slot Engine on one device) and
``train`` (the training driver, with checkpoints and fault recovery)."""
