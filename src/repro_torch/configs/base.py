"""Architecture configs: the assigned 10 architectures as frozen
dataclasses, plus reduced variants for CPU smoke tests and storage-free
input stand-ins for the dry-run.

A copy of the reference's ``repro/configs/base.py``: the configs are
data, so the whole registry comes across.  ``ArchConfig.input_specs``
gives the reference's ``jax.ShapeDtypeStruct`` stand-ins as tensors
without storage: on the ``meta`` device by default, or fake tensors when
called under ``FakeTensorMode`` with a real device, as the dry-run
(``launch/dryrun.py``) calls it."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclass(frozen=True)
class RGCfg:
    """RecurrentGemma block pattern: `pattern` recurrent blocks then one
    local-attention block, repeated."""
    lru_width: int = 2560
    conv_width: int = 4
    pattern: int = 2          # rec blocks per attention block


@dataclass(frozen=True)
class XLSTMCfg:
    """xLSTM block mix: every `slstm_every`-th block is sLSTM."""
    slstm_every: int = 6
    proj_factor: float = 2.0   # mLSTM up-projection
    ff_factor: float = 1.3333  # sLSTM ffn factor


@dataclass(frozen=True)
class EncDecCfg:
    """Whisper-style encoder config (conv frontend stubbed: inputs are
    precomputed frame embeddings)."""
    n_enc_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionCfg:
    """Llama-3.2-Vision: cross-attn layers every `cross_every` blocks;
    the vision tower is stubbed (input_specs provides patch embeddings)."""
    n_image_tokens: int = 1601
    d_vision: int = 4096
    cross_every: int = 5


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0           # 0 => d_model // n_heads
    attn_kind: str = "full"   # full | local | alternating(gemma2)
    window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_base: float = 10000.0
    act: str = "silu"
    post_norms: bool = False  # gemma2 post-attn/ffn norms
    moe: Optional[MoECfg] = None
    dense_layers: int = 0     # leading dense layers in a MoE stack (dsv3: 3)
    mla: Optional[MLACfg] = None
    mtp: bool = False         # deepseek-v3 multi-token prediction head
    rg: Optional[RGCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    encdec: Optional[EncDecCfg] = None
    vision: Optional[VisionCfg] = None
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k (needs sub-quadratic attention &
        O(1)-ish decode state)?  Pure/partial full attention disqualifies
        (gemma2 global layers, all dense/moe/vlm/audio archs)."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    # -- parameter count (analytic; for roofline MODEL_FLOPS) -----------
    def param_count(self) -> int:
        D, V, L = self.d_model, self.vocab, self.n_layers
        Hq, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        emb = 2 * V * D  # untied in+out embeddings
        per_attn = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        if self.mla is not None:
            m = self.mla
            per_attn = (D * m.q_lora + m.q_lora * Hq * (m.d_nope + m.d_rope)
                        + D * (m.kv_lora + m.d_rope)
                        + m.kv_lora * Hq * (m.d_nope + m.d_v)
                        + Hq * m.d_v * D)
        per_mlp = 3 * D * self.d_ff
        total = emb
        if self.family == "ssm" and self.xlstm is not None:
            # mLSTM blocks: up-proj 2x, qkv, gates, down;  rough analytic
            dm = int(self.d_model * self.xlstm.proj_factor)
            per_m = 2 * D * dm + 3 * dm * dm // max(1, self.n_heads) + dm * D
            return emb + L * per_m
        if self.rg is not None:
            lw = self.rg.lru_width
            rec = 2 * D * lw + lw * D + 2 * lw  # in/out proj + gates
            n_attn = L // (self.rg.pattern + 1)
            n_rec = L - n_attn
            return (emb + n_rec * (rec + per_mlp) + n_attn * (per_attn + per_mlp))
        if self.moe is not None:
            mo = self.moe
            per_moe = (D * mo.num_experts            # router
                       + mo.num_experts * 3 * D * mo.d_expert_ff
                       + mo.n_shared * 3 * D * (mo.d_shared_ff or mo.d_expert_ff))
            n_dense = self.dense_layers
            total += n_dense * (per_attn + 3 * D * (self.d_ff if self.family == "moe" and self.name.startswith("deepseek") else self.d_ff))
            total += (L - n_dense) * (per_attn + per_moe)
            return total
        if self.encdec is not None:
            enc = self.encdec.n_enc_layers * (per_attn + 2 * D * self.d_ff)
            dec = L * (2 * per_attn + 2 * D * self.d_ff)  # self+cross
            return emb + enc + dec
        if self.vision is not None:
            n_cross = L // self.vision.cross_every
            cross = n_cross * (per_attn + D * self.vision.d_vision)
            return emb + L * (per_attn + per_mlp) + cross
        return total + L * (per_attn + per_mlp)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        D, L = self.d_model, self.n_layers
        dense_total = self.param_count()
        full_moe = (L - self.dense_layers) * mo.num_experts * 3 * D * mo.d_expert_ff
        act_moe = (L - self.dense_layers) * mo.top_k * 3 * D * mo.d_expert_ff
        return dense_total - full_moe + act_moe

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            d_ff=128,
            vocab=256,
            d_head=16,
            window=min(self.window, 16),
        )
        if self.moe:
            # dropless capacity in the reduced config so prefill+decode
            # exactly matches forward (capacity dropping is non-causal).
            # C = int(cf*B*T*k/E) only covers the worst case of every
            # token routing to one expert (B*T*k slots) when cf >= E;
            # cf=4 < 8 left the one-token decode step with C=2.
            kw["moe"] = replace(self.moe, num_experts=8, top_k=2,
                                d_expert_ff=32, d_shared_ff=32,
                                capacity_factor=8.0)
            kw["dense_layers"] = min(self.dense_layers, 1)
        if self.mla:
            kw["mla"] = MLACfg(q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16)
        if self.rg:
            kw["rg"] = replace(self.rg, lru_width=64, conv_width=4)
        if self.encdec:
            kw["encdec"] = replace(self.encdec, n_enc_layers=2, n_frames=16)
        if self.vision:
            kw["vision"] = replace(self.vision, n_image_tokens=8, d_vision=32,
                                   cross_every=2)
        if self.xlstm:
            kw["xlstm"] = replace(self.xlstm, slstm_every=2)
        return replace(self, **kw)

    def input_specs(self, shape_name: str, global_batch: Optional[int] = None,
                    seq_len: Optional[int] = None, device="meta"
                    ) -> Dict[str, torch.Tensor]:
        """Stand-ins for every model input of a shape cell, the keys,
        shapes and dtypes of the reference's ``input_specs``
        (``repro/configs/base.py:204-235``), allocating no storage."""
        sh = SHAPES[shape_name]
        B = global_batch if global_batch is not None else sh.global_batch
        S = seq_len if seq_len is not None else sh.seq_len
        i32 = torch.int32

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        if sh.kind == "train":
            d = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32),
                 "mask": spec((B, S), torch.float32)}
        elif sh.kind == "prefill":
            d = {"tokens": spec((B, S), i32)}
        else:  # decode: one new token against a cache of length S
            d = {"token": spec((B, 1), i32), "pos": spec((B,), i32)}
        # modality-frontend stubs: precomputed embeddings are inputs for
        # train/prefill; decode reads the cross-KV cached at prefill
        if sh.kind != "decode":
            if self.encdec is not None:
                d["frames"] = spec((B, self.encdec.n_frames, self.d_model),
                                   torch.bfloat16)
            if self.vision is not None:
                d["image_embeds"] = spec(
                    (B, self.vision.n_image_tokens, self.vision.d_vision),
                    torch.bfloat16)
        return d

    def supports_shape(self, shape_name: str) -> Tuple[bool, str]:
        sh = SHAPES[shape_name]
        if shape_name == "long_500k" and not self.subquadratic:
            return False, "full attention is quadratic; skipped per assignment"
        return True, ""


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import ALL_ARCHS  # ensure registration side effects ran
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    from . import ALL_ARCHS
    return dict(_REGISTRY)
