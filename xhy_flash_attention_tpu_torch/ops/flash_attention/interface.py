"""Public flash-attention API (≙ xhy_flash_attention_tpu
ops/flash_attention/interface.py), and decode against a growing KV cache
(`flash_attn_with_kvcache`).

`flash_attention` is differentiable in q, k and v: when an input needs a
gradient it runs as an autograd function, as the TPU package's custom VJP
(interface.py:96-131): the forward saves (q, k, v, out, lse) and the
backward calls `flash_attention_bwd` (the dK/dV and dQ kernels). The same
function carries the FlashMask and block-sparse entries (flashmask.py,
blocksparse.py) with their mask flags. Decode against a cache has no
backward, as in the TPU package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..decode import write_kv
from ..quant import QuantizedKV
from .bwd import flash_attention_bwd
from .decode_kernel import flash_decode
from .fwd import _check_supported, flash_attention_fwd

__all__ = ["flash_attention", "flash_attn_func", "flash_attn_qkvpacked_func",
           "flash_attn_with_kvcache"]


class _FlashAttention(torch.autograd.Function):
    """``masks``: the forward's mask flags (``flashmask_vecs``,
    ``flashmask_mode``, ``block_mask``) as a dict, or None."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, softcap, masks):
        ctx.kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
                      **(masks or {}))
        out, lse = flash_attention_fwd(q, k, v, need_lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, softmax_scale: Optional[float], causal: bool,
              softcap: float = 0.0, return_lse: bool = False, masks=None):
    """(b, h, s, d) attention through the autograd function when an input
    needs a gradient, else the forward alone; ``masks`` as
    `_FlashAttention`'s. Returns out, or (out, lse) with ``return_lse``."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, float(softmax_scale),
                                         causal, float(softcap), masks)
    else:
        out, lse = flash_attention_fwd(
            q, k, v, sm_scale=softmax_scale, causal=causal, softcap=softcap,
            need_lse=return_lse, **(masks or {}))
    return (out, lse) if return_lse else out


def flash_attention(
    q, k, v, bias=None, q_segment_ids=None, kv_segment_ids=None, *,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    dropout_seed=None,
    return_lse: bool = False,
    q_positions=None,
    kv_positions=None,
):
    """Kernel-layout attention: q (b, h, sq, d), k/v (b, hk, sk, d).

    Returns out (b, h, sq, d) and, with ``return_lse``, the fp32 logsumexp
    (b, h, sq). Differentiable in q, k and v (not through the LSE).
    """
    causal = _check_supported(causal, window_size, dropout_p, {
        "bias": bias, "segment ids": q_segment_ids,
        "kv segment ids": kv_segment_ids, "q positions": q_positions,
        "kv positions": kv_positions})
    return attention(q, k, v, softmax_scale=softmax_scale, causal=causal,
                     softcap=softcap, return_lse=return_lse)


def flash_attn_func(q, k, v, dropout_p: float = 0.0,
                    softmax_scale: Optional[float] = None,
                    causal: bool = False,
                    window_size: Tuple[int, int] = (-1, -1),
                    softcap: float = 0.0,
                    deterministic: bool = True,
                    dropout_seed=None):
    """q: (batch, seqlen_q, nheads, head_dim); k/v: (batch, seqlen_k,
    nheads_k, head_dim). Returns out in the same layout.

    The layout swaps are views: the kernels read strided inputs, and the
    output and the gradients come back in (b, s, h, d) memory order. The
    kernels are deterministic, so ``deterministic`` is accepted and ignored.
    """
    del deterministic
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, dropout_p=dropout_p, dropout_seed=dropout_seed)
    return out.transpose(1, 2)


def flash_attn_qkvpacked_func(qkv, dropout_p: float = 0.0,
                              softmax_scale: Optional[float] = None,
                              causal: bool = False,
                              window_size: Tuple[int, int] = (-1, -1),
                              softcap: float = 0.0,
                              deterministic: bool = True,
                              dropout_seed=None):
    """qkv: (batch, seqlen, 3, nheads, head_dim). Returns (batch, seqlen,
    nheads, head_dim); the gradient of qkv gathers dq, dk and dv."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (b, s, 3, h, d), got {tuple(qkv.shape)}")
    return flash_attn_func(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, deterministic=deterministic,
        dropout_seed=dropout_seed)


def _rotate_at(x, rotary_cos, rotary_sin, pos, interleaved):
    """Rotary on (b, sq, heads, d) at per-sample positions pos (b, sq)."""
    from ...layers.rotary import apply_rotary_emb
    pos = pos.long()
    return apply_rotary_emb(x, rotary_cos[pos], rotary_sin[pos], interleaved)


def flash_attn_with_kvcache(
    q,
    k_cache,
    v_cache,
    k=None,
    v=None,
    rotary_cos=None,
    rotary_sin=None,
    cache_seqlens=None,
    cache_batch_idx=None,
    cache_leftpad=None,
    softmax_scale=None,
    causal: bool = True,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    rotary_interleaved: bool = False,
    num_splits: int = 1,
):
    """Decode against a growing KV cache under the FlashAttention name.

    q: (b, sq, h, d). k_cache/v_cache: (b, S, hk, d) dense tensors in the
    reference layout, read in place through their strides; or a QuantizedKV
    pair (already (b, hk, S, d) with per-token scales); or a PagedKVCache as
    k_cache with v_cache None. k/v: optional (b, sq, hk, d) new tokens,
    appended at position ``cache_seqlens`` before attending (both or
    neither). rotary_cos/sin: (max_s, rot/2) tables applied to q and the new
    k at each sample's absolute positions. cache_seqlens: int or (b,) tokens
    already in the cache. cache_batch_idx: (b,) cache row serving query row
    i (not with k/v). cache_leftpad: (b,) first valid cache column; as in
    the JAX package, cache_seqlens counts the tokens after the pad.
    num_splits != 1 runs the split-KV kernel (0 = heuristic), without
    cache_batch_idx and cache_leftpad.

    The caches are updated in place and the same objects are returned (the
    JAX package, being functional, returns new ones): with k/v the call
    returns ``(out, k_cache, v_cache)``, or ``(out, cache)`` for a paged
    cache, whose pages are written in place and whose returned PagedKVCache
    carries the advanced lengths. Without k/v it returns ``out``. With sq > 1
    the new queries attend causally at their positions.
    """
    from ...inference.paged import (PagedKVCache, append_paged_kv,
                                    paged_flash_decode)

    b, sq, h, d = q.shape
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if sq > 1 and not causal:
        raise NotImplementedError(
            "sq > 1 with causal=False: new queries always attend at their "
            "causal positions here")
    if (k is None) != (v is None):
        raise ValueError("pass the new keys and values together (k and v)")
    appending = k is not None
    window_size = (int(window_size[0]), int(window_size[1]))
    arange = torch.arange(sq, device=q.device)[None]

    if isinstance(k_cache, PagedKVCache):
        if v_cache is not None:
            raise ValueError(
                "a PagedKVCache carries both K and V: pass v_cache=None")
        for bad, name in ((cache_batch_idx, "cache_batch_idx"),
                          (cache_leftpad, "cache_leftpad")):
            if bad is not None:
                raise NotImplementedError(f"{name} with a paged cache")
        cache = k_cache
        if appending:
            if rotary_cos is not None:
                pos = cache.lengths.long()[:, None] + arange
                q = _rotate_at(q, rotary_cos, rotary_sin, pos,
                               rotary_interleaved)
                k = _rotate_at(k, rotary_cos, rotary_sin, pos,
                               rotary_interleaved)
            cache = append_paged_kv(cache, k.transpose(1, 2),
                                    v.transpose(1, 2))
        elif rotary_cos is not None:
            pos = cache.lengths.long()[:, None] - sq + arange
            q = _rotate_at(q, rotary_cos, rotary_sin, pos, rotary_interleaved)
        out = paged_flash_decode(q, cache, softmax_scale=float(softmax_scale),
                                 window_size=window_size, softcap=float(softcap))
        return (out, cache) if appending else out

    if isinstance(k_cache, QuantizedKV):
        S = k_cache.values.shape[2]
        kc, vc = k_cache, v_cache
    else:
        # reference cache layout (b, S, hk, d) -> kernel layout, as views
        S = k_cache.shape[1]
        kc, vc = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    if cache_seqlens is None:
        if appending:
            raise ValueError("appending k/v requires cache_seqlens")
        lens0 = torch.full((b,), S, dtype=torch.int32, device=q.device)
    else:
        lens0 = torch.as_tensor(cache_seqlens, device=q.device).to(
            torch.int32).expand(b).contiguous()
    if cache_batch_idx is not None:
        cache_batch_idx = cache_batch_idx.to(torch.int32).contiguous()
    if cache_leftpad is not None:
        cache_leftpad = cache_leftpad.to(torch.int32).contiguous()

    if appending:
        if cache_batch_idx is not None:
            raise NotImplementedError(
                "cache_batch_idx with k/v append: shared cache rows would be "
                "written once per query row; append first, then call with "
                "k=None")
        if rotary_cos is not None:
            pos = lens0.long()[:, None] + arange
            q = _rotate_at(q, rotary_cos, rotary_sin, pos, rotary_interleaved)
            k = _rotate_at(k, rotary_cos, rotary_sin, pos, rotary_interleaved)
        off = lens0 if cache_leftpad is None else lens0 + cache_leftpad
        write_kv(kc, k, off)
        write_kv(vc, v, off)
    elif rotary_cos is not None:
        pos = lens0.long()[:, None] - sq + arange
        q = _rotate_at(q, rotary_cos, rotary_sin, pos, rotary_interleaved)
    lengths = lens0 + sq if appending else lens0

    if num_splits != 1 and cache_batch_idx is None and cache_leftpad is None:
        from ...inference.combine import flash_decode_splitkv

        out = flash_decode_splitkv(
            q, kc, vc, lengths, softmax_scale=float(softmax_scale),
            num_splits=num_splits, window_size=window_size,
            softcap=float(softcap))
    else:
        out = flash_decode(
            q, kc, vc, lengths, softmax_scale=float(softmax_scale),
            window_size=window_size, softcap=float(softcap),
            kv_batch_idx=cache_batch_idx, leftpad_k=cache_leftpad)
    return (out, k_cache, v_cache) if appending else out
