"""Model zoo of the port: the dense decoder family (gemma2's windows
included), the moe family, the RG-LRU hybrid (recurrentgemma) and the
xLSTM LM, assembled in lm.build() (the other families are still to port,
ROADMAP)."""
from .lm import ModelBundle, build

__all__ = ["ModelBundle", "build"]
