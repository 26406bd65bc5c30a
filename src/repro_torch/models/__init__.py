"""Model zoo of the port: the dense decoder family, assembled in
lm.build() (the other families are still to port, ROADMAP)."""
from .lm import ModelBundle, build

__all__ = ["ModelBundle", "build"]
