"""Inference runtime: paged KV cache, split-KV decode, continuous batching
(≙ xhy_flash_attention_tpu inference/).

`tp_model_apply` (tensor-parallel serving) comes with slice 9
(parallelism) (ROADMAP.md, 'Next slices of the port').
"""

from .combine import flash_decode_splitkv, merge_attention_partials
from .engine import InferenceEngine, Request
from .fused_step import fused_decode_step
from .paged import PagedKVCache, append_paged_kv, paged_flash_decode

__all__ = [
    "InferenceEngine",
    "PagedKVCache",
    "Request",
    "append_paged_kv",
    "flash_decode_splitkv",
    "fused_decode_step",
    "merge_attention_partials",
    "paged_flash_decode",
]
