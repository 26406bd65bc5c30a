"""Aggregates the 10 assigned architecture configs (one module each)."""
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .deepseek_7b import CONFIG as deepseek_7b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .yi_9b import CONFIG as yi_9b
from .gemma2_9b import CONFIG as gemma2_9b
from .llama32_vision_11b import CONFIG as llama_32_vision_11b
from .xlstm_125m import CONFIG as xlstm_125m
from .whisper_base import CONFIG as whisper_base

ALL = [recurrentgemma_2b, deepseek_v3_671b, qwen3_moe_30b_a3b, deepseek_7b,
       mistral_large_123b, yi_9b, gemma2_9b, llama_32_vision_11b,
       xlstm_125m, whisper_base]
