"""llama-3.2-vision-11b [vlm]: cross-attn image layers every 5 blocks;
vision tower STUBBED (input_specs provides precomputed patch embeddings).
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig, VisionCfg, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, d_head=128,
    vision=VisionCfg(n_image_tokens=1601, d_vision=4096, cross_every=5),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
))
