"""Decode-time attention: few queries against a KV cache with per-sample
lengths (≙ xhy_flash_attention_tpu ops/decode.py).

The TPU package sends caches shorter than 1024 positions to an XLA math
path and longer ones to its Pallas kernel (decode.py:71-74); that threshold
was a TPU tiling choice. Here a CUDA tensor always goes to the decode
kernel, and a CPU tensor to the plain math `_decode_attention_xla`.
"""

from __future__ import annotations

from .flash_attention.decode_kernel import flash_decode
from .flash_attention.decode_kernel import \
    flash_decode_ref as _decode_attention_xla

__all__ = ["decode_attention"]


def decode_attention(q, k_cache, v_cache, lengths, softmax_scale,
                     window_size=(-1, -1), softcap: float = 0.0,
                     kv_batch_idx=None, leftpad_k=None):
    """q: (b, sq, h, d) new queries; k/v_cache: (b, hk, max_s, d);
    lengths: (b,) valid cache length including the new tokens, which must
    already be written into the cache. Row r of the query attends cache
    positions <= lengths - sq + r."""
    return flash_decode(
        q, k_cache, v_cache, lengths, softmax_scale=softmax_scale,
        window_size=window_size, softcap=softcap, kv_batch_idx=kv_batch_idx,
        leftpad_k=leftpad_k)
