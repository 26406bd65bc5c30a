"""Launchers of the port: ``serve`` (the slot Engine on one device),
``train`` (the training driver, with checkpoints and fault recovery),
``mesh`` (the production meshes) and ``dryrun`` (every architecture x
shape x mesh cell traced on fake tensors over a fake process group)."""
