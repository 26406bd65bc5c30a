"""xlstm-125m [ssm]: sLSTM + mLSTM blocks, attention-free.
12L d_model=768 4H vocab=50304. [arXiv:2405.04517; unverified]"""
from .base import ArchConfig, XLSTMCfg, register

CONFIG = register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, d_head=192,
    xlstm=XLSTMCfg(slstm_every=6, proj_factor=2.0),
    source="arXiv:2405.04517; unverified",
))
