"""Decode-time attention: few queries against a KV cache with per-sample
lengths (≙ xhy_flash_attention_tpu ops/decode.py), and the in-place write of
new keys and values into a dense cache.

The TPU package sends caches shorter than 1024 positions to an XLA math
path and longer ones to its Pallas kernel (decode.py:71-74); that threshold
was a TPU tiling choice. Here a CUDA tensor always goes to the decode
kernel, and a CPU tensor to the plain math `_decode_attention_xla`.
"""

from __future__ import annotations

import torch

from .flash_attention.decode_kernel import flash_decode
from .flash_attention.decode_kernel import \
    flash_decode_ref as _decode_attention_xla
from .quant import QuantizedKV, bits, quantize_kv

__all__ = ["decode_attention", "write_kv"]


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


def write_kv(cache, new: torch.Tensor, offset) -> None:
    """Write new (b, sq, hk, d) keys or values into a dense (b, hk, S, d)
    cache (a tensor or QuantizedKV, quantized per token) in place, at
    ``offset``: an int (a slice write), or a (b,) tensor of per-sample
    positions (an indexed write that reads the positions on the device only,
    as a step captured in a CUDA graph needs)."""
    new = new.transpose(1, 2)
    if isinstance(cache, QuantizedKV):
        q = quantize_kv(new, cache.values.dtype)
        write_kv(cache.values, q.values.transpose(1, 2), offset)
        write_kv(cache.scales, q.scales.transpose(1, 2), offset)
        return
    sq = new.shape[2]
    if not isinstance(offset, torch.Tensor):
        bits(cache)[:, :, offset:offset + sq] = bits(new.to(cache.dtype))
        return
    b = new.shape[0]
    pos = offset.to(device=cache.device, dtype=torch.int64).expand(b)[:, None] \
        + torch.arange(sq, device=cache.device)
    bi = torch.arange(b, device=cache.device)[:, None].expand(b, sq)
    bits(cache)[bi, :, pos] = bits(new.to(cache.dtype)).transpose(1, 2)
