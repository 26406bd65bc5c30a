"""Model zoo of the port: the dense decoder family (gemma2's windows
included), the moe family, the vision decoder (llama-3.2-vision), the
encoder-decoder (whisper), the RG-LRU hybrid (recurrentgemma) and the
xLSTM LM, assembled in lm.build() (the mla family is still to port,
ROADMAP)."""
from .lm import ModelBundle, build

__all__ = ["ModelBundle", "build"]
