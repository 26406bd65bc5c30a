"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, no shared expert.
48L d_model=2048 32H (GQA kv=4) expert_ff=768 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151936, d_head=128,
    moe=MoECfg(num_experts=128, top_k=8, d_expert_ff=768, n_shared=0),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
