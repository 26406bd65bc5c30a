"""Model zoo of the port: the dense decoder family (gemma2's windows
included) and the moe family, assembled in lm.build() (the other
families are still to port, ROADMAP)."""
from .lm import ModelBundle, build

__all__ = ["ModelBundle", "build"]
