"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8 experts, MTP.
61L d_model=7168 128H d_ff(dense)=18432 expert_ff=2048 vocab=129280.
[arXiv:2412.19437; hf]"""
from .base import ArchConfig, MLACfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab=129280, d_head=128,
    moe=MoECfg(num_experts=256, top_k=8, d_expert_ff=2048, n_shared=1,
               d_shared_ff=2048),
    dense_layers=3,
    mla=MLACfg(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    mtp=True,
    source="arXiv:2412.19437; hf",
))
