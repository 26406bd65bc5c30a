"""Launchers of the port: ``serve`` (the slot Engine on one device)."""
