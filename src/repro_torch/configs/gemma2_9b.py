"""gemma2-9b [dense]: local+global alternating attention, logit softcaps,
post-norms. 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
[arXiv:2408.00118; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, d_head=256, attn_kind="alternating", window=4096,
    attn_softcap=50.0, final_softcap=30.0, act="gelu", post_norms=True,
    source="arXiv:2408.00118; hf",
))
