"""deepseek-7b [dense]: llama-arch MHA.
30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400. [arXiv:2401.02954; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400, d_head=128,
    source="arXiv:2401.02954; hf",
))
