"""Decode step: rotary, cache append and attention (≙ xhy_flash_attention_tpu
inference/fused_step.py `fused_decode_step`).

The TPU package fuses the three into one jitted dispatch with the cache
donated. Here the step is rotary in plain PyTorch, the append written in
place into the caller's cache (no copy of the cache), then the attention
kernel (flash_decode for dense and quantized caches, paged_flash_decode for
a PagedKVCache). A tensor ``lengths`` is read on the device only and
nothing else of the step is read on the host, so the caller can capture it
in a CUDA graph (utils/generation.py `CUDAGraphStep`) with its q, new keys
and values, lengths and caches as fixed tensors updated in place between
replays, as the engine's decode step is captured.

Supports the three cache kinds of modules/mha.py:
  * dense (k_cache, v_cache) tensors (b, hk, S, d);
  * QuantizedKV dense caches (int8 / e4m3 payload with per-token scales);
  * PagedKVCache (continuous batching) through append_paged_kv and
    paged_flash_decode;
with per-sample ``lengths`` (ragged decode positions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..layers.rotary import apply_rotary_emb
from ..ops.decode import write_kv
from ..ops.flash_attention.decode_kernel import flash_decode
from .paged import PagedKVCache, append_paged_kv, paged_flash_decode

__all__ = ["fused_decode_step"]


def _rotary_at(x, lengths, inv_freq, interleaved):
    """Rotary on (b, sq, h, d) new tokens at per-sample positions
    lengths[b] + t."""
    sq = x.shape[1]
    pos = lengths.long()[:, None] + torch.arange(sq, device=x.device)[None]
    freqs = pos[..., None].float() * inv_freq.float()
    return apply_rotary_emb(x, freqs.cos().to(x.dtype),
                            freqs.sin().to(x.dtype), interleaved)


def fused_decode_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache,
    lengths: Optional[torch.Tensor] = None,
    inv_freq: Optional[torch.Tensor] = None,
    *,
    softmax_scale: float,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    interleaved: bool = False,
):
    """One decode step (rotary -> append -> attend), appending in place.

    q: (b, sq, h, d) new queries (pre-rotary when inv_freq is given);
    k_new/v_new: (b, hk, sq, d) new keys/values (pre-rotary);
    cache: (k_cache, v_cache) dense tensors or QuantizedKV pair, written in
        place; or a PagedKVCache, whose pages are written in place;
    lengths: (b,) int32 tokens already in the cache per sample, a tensor on
        q's device for a captured step (omit for a PagedKVCache: it carries
        its own);
    inv_freq: optional (rot_dim/2,) rotary inverse frequencies; None skips
        rotary.

    Returns (out (b, sq, h, d), cache): the same dense caches, or a new
    PagedKVCache over the same pages with advanced lengths (a new tensor:
    the cache's own lengths are not changed, so a captured step replays
    from the lengths the caller writes into it).
    """
    if lengths is None:
        if not isinstance(cache, PagedKVCache):
            raise ValueError("lengths may only be omitted for a PagedKVCache")
        lengths = cache.lengths
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    if inv_freq is not None:
        q = _rotary_at(q, lengths, inv_freq, interleaved)
        k_new = _rotary_at(k_new.transpose(1, 2), lengths, inv_freq,
                           interleaved).transpose(1, 2)
    sq = q.shape[1]
    if isinstance(cache, PagedKVCache):
        cache = append_paged_kv(cache, k_new, v_new)
        out = paged_flash_decode(q, cache, softmax_scale=softmax_scale,
                                 window_size=window_size, softcap=softcap)
        return out, cache
    k_cache, v_cache = cache
    write_kv(k_cache, k_new.transpose(1, 2), lengths)
    write_kv(v_cache, v_new.transpose(1, 2), lengths)
    out = flash_decode(q, k_cache, v_cache, lengths + sq,
                       softmax_scale=softmax_scale, window_size=window_size,
                       softcap=softcap)
    return out, cache
