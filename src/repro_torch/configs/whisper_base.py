"""whisper-base [audio]: encoder-decoder; conv frontend STUBBED
(input_specs provides precomputed frame embeddings (B, 1500, 512)).
6L d_model=512 8H d_ff=2048 vocab=51865. [arXiv:2212.04356; unverified]"""
from .base import ArchConfig, EncDecCfg, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, d_head=64, act="gelu",
    encdec=EncDecCfg(n_enc_layers=6, n_frames=1500),
    source="arXiv:2212.04356; unverified",
))
