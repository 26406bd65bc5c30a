"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern.
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000. [arXiv:2402.19427; hf]"""
from .base import ArchConfig, RGCfg, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, d_head=256, attn_kind="local", window=2048, act="gelu",
    rg=RGCfg(lru_width=2560, conv_width=4, pattern=2),
    source="arXiv:2402.19427; hf",
))
