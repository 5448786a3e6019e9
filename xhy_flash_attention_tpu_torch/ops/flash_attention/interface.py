"""Public flash-attention API (≙ xhy_flash_attention_tpu
ops/flash_attention/interface.py), and decode against a growing KV cache
(`flash_attn_with_kvcache`).

`flash_attention` is differentiable in q, k, v and the attention bias:
when an input needs a gradient it runs as an autograd function, as the TPU
package's custom VJP (interface.py:96-131): the forward makes the kernels'
mask arguments once (fwd.build_masks), saves (q, k, v, bias, out, lse) and
hands the same arguments to the backward, which calls
`flash_attention_bwd` (the dK/dV and dQ kernels, and the dbias kernel when
the bias needs its gradient). The same function carries the FlashMask and
block-sparse entries (flashmask.py, blocksparse.py), sliding windows,
segment ids and q/kv positions, and attention dropout (``dropout_p`` and
``dropout_seed`` handed to both passes, which regenerate one keep mask).
Varlen is packed attention over a batch
of 1, as in the TPU package (interface.py:365-433): segment ids from
``cu_seqlens``, and under a causal or windowed mask per-sequence positions
aligned to the bottom right, all made on the device. Decode against a
cache has no backward, as in the TPU package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..decode import write_kv
from ..quant import QuantizedKV
from .bwd import flash_attention_bwd
from .common import BlockSizes, Dropout
from .decode_kernel import flash_decode
from .fwd import (FP8, bias_view, build_masks, check_supported,
                  flash_attention_fwd)
from .remat import saved_attention

__all__ = ["flash_attention", "flash_attn_func", "flash_attn_kvpacked_func",
           "flash_attn_fp8_func", "flash_attn_qkvpacked_func",
           "flash_attn_varlen_func",
           "flash_attn_varlen_kvpacked_func",
           "flash_attn_varlen_qkvpacked_func", "flash_attn_with_kvcache"]


class _FlashAttention(torch.autograd.Function):
    """``masks``: the kernels' mask arguments (fwd.build_masks), made once
    for both passes; ``causal`` the plain causal flag build_masks
    returned; ``bias`` an attention bias (fwd.bias_view's shapes) or None.
    The backward launches the dbias kernel only when the bias needs a
    gradient, and the dK/dV and dQ kernels only when q, k or v does.
    ``dropout_p`` and ``dropout_seed``: the same for both passes. Under a rematerialised block the forward's (out, lse) are
    saved (remat.saved_attention)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, causal, softcap, masks,
                dropout_p, dropout_seed):
        ctx.kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
                      masks=masks, dropout_p=dropout_p,
                      dropout_seed=dropout_seed)
        out, lse = saved_attention(lambda: flash_attention_fwd(
            q, k, v, bias, need_lse=True, **ctx.kw), q)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = flash_attention_bwd(
            q, k, v, out, lse, dout, bias, need_dqkv=any(need[:3]),
            need_dbias=bias is not None and need[3], **ctx.kw)
        dbias = grads[3] if bias is not None else None
        return (*grads[:3], dbias, None, None, None, None, None, None)


def attention(q, k, v, *, softmax_scale: Optional[float], causal: bool,
              softcap: float = 0.0, return_lse: bool = False, masks=None,
              window_size: Tuple[int, int] = (-1, -1), bias=None,
              dropout_p: float = 0.0, dropout_seed=None):
    """(b, h, s, d) attention through the autograd function when an input
    (the bias included) needs a gradient, else the forward alone.
    ``masks``: a dict of the forward's mask flags
    (``flashmask_vecs``/``flashmask_mode``, ``block_mask``,
    ``q_segment_ids``/``kv_segment_ids``, ``q_positions``/``kv_positions``)
    or None. ``dropout_p`` / ``dropout_seed``: as :func:`flash_attention`.
    Returns out, or (out, lse) with ``return_lse``."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, _ = q.shape
    causal, kmasks = build_masks(b, h, sq, k.shape[2], causal, window_size,
                                 **(masks or {}))
    kw = dict(sm_scale=float(softmax_scale), causal=causal,
              softcap=float(softcap), masks=kmasks,
              dropout_p=float(dropout_p), dropout_seed=dropout_seed)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        out, lse = _FlashAttention.apply(q, k, v, bias, *kw.values())
    else:
        out, lse = flash_attention_fwd(q, k, v, bias, need_lse=return_lse,
                                       **kw)
    return (out, lse) if return_lse else out


def flash_attention(
    q, k, v, bias=None, q_segment_ids=None, kv_segment_ids=None, *,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    dropout_seed=None,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    q_positions=None,
    kv_positions=None,
):
    """Kernel-layout attention: q (b, h, sq, d), k/v (b, hk, sk, d).

    Returns out (b, h, sq, d) and, with ``return_lse``, the fp32 logsumexp
    (b, h, sq). Differentiable in q, k, v and ``bias`` (not through the
    LSE). bias: an additive fp32 or bf16 (sq, sk), (bb, sq, sk) or (bb,
    bh, sq, sk) tensor, bb in {1, b}, bh in {1, h}, added to the scores
    after softcap and before the masks; its gradient is summed over the
    axes it broadcasts and has its shape and dtype.
    window_size (left, right): key c visible to row r when r + offset -
    left <= c <= r + offset + right (offset sk - sq, -1 no bound; causal
    sets right to 0). q_segment_ids / kv_segment_ids ((b, sq) / (b, sk)
    int): only equal ids attend. q_positions / kv_positions ((b, sq) / (b,
    sk) int): the causal and window bounds apply to the positions instead
    (kpos <= qpos + right, kpos >= qpos - left), as ring attention and
    varlen with different q/k packings use them. dropout_p > 0 drops
    elements of the attention probabilities by the keep mask
    :func:`common.dropout_keep_mask` keyed on ``dropout_seed`` (an int or a
    one-element int tensor, required), the same in the backward; on the
    card in bf16 without a bias (``NotImplementedError`` else). The CUDA
    tiles are fixed per head dim, so ``block_sizes`` is accepted and
    ignored.
    """
    del block_sizes
    if dropout_p > 0.0 and FP8 in (q.dtype, k.dtype, v.dtype):
        raise ValueError("the fp8 forward takes no dropout")
    check_supported(q, bias, dropout_p, "flash_attention")
    if bias is not None:
        bias_view(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    flags = {name: t for name, t in (
        ("q_segment_ids", q_segment_ids), ("kv_segment_ids", kv_segment_ids),
        ("q_positions", q_positions), ("kv_positions", kv_positions))
        if t is not None}
    return attention(q, k, v, softmax_scale=softmax_scale, causal=causal,
                     softcap=softcap, return_lse=return_lse, masks=flags,
                     window_size=window_size, bias=bias,
                     dropout_p=dropout_p, dropout_seed=dropout_seed)


def _attn_probs_debug(qt, kt, lse, *, softmax_scale, causal, window_size,
                      softcap, dropout_p=0.0, dropout_seed=None, q_seg=None,
                      k_seg=None, qpos=None, kpos=None):
    """The S_dmask debug tensor (b, h, sq, sk) of the TPU package
    (interface.py:187-241): the softmax probabilities recomputed from the
    LSE in plain PyTorch (an O(sq * sk) tensor; the kernels never make
    it); masked pairs and rows with no key give 0; with dropout the
    entries the keep mask drops are negated (the reference's encoding:
    the mask is S_dmask >= 0)."""
    b, h, sq, _ = qt.shape
    hk, sk = kt.shape[1], kt.shape[2]
    kf = kt.float().repeat_interleave(h // hk, dim=1)
    s = (qt.float() @ kf.transpose(-1, -2)) * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    left, right = window_size
    if causal:
        right = 0
    if qpos is not None:
        qp = qpos[:, None, :, None].long()
        kp = kpos[:, None, None, :].long()
    else:
        qp = (torch.arange(sq, device=qt.device)[:, None] + (sk - sq))
        kp = torch.arange(sk, device=qt.device)[None, :]
    if right >= 0:
        s = s.masked_fill(~(kp <= qp + right), -math.inf)
    if left >= 0:
        s = s.masked_fill(~(kp >= qp - left), -math.inf)
    if q_seg is not None:
        s = s.masked_fill(q_seg[:, None, :, None] != k_seg[:, None, None, :],
                          -math.inf)
    p = torch.exp(s - lse[..., None])
    drop = Dropout.make(dropout_p, dropout_seed)
    if drop is not None:
        p = torch.where(drop.keep(b, h, sq, sk, qt.device), p, -p)
    return p


def flash_attn_func(q, k, v, dropout_p: float = 0.0,
                    softmax_scale: Optional[float] = None,
                    causal: bool = False,
                    window_size: Tuple[int, int] = (-1, -1),
                    softcap: float = 0.0,
                    return_attn_probs: bool = False,
                    deterministic: bool = True,
                    dropout_seed=None,
                    block_sizes: Optional[BlockSizes] = None):
    """q: (batch, seqlen_q, nheads, head_dim); k/v: (batch, seqlen_k,
    nheads_k, head_dim). Returns out in the same layout; with
    ``return_attn_probs`` (out, softmax_lse (b, h, sq), S_dmask (b, h, sq,
    sk)), S_dmask the debug probabilities (:func:`_attn_probs_debug`).

    The layout swaps are views: the kernels read strided inputs, and the
    output and the gradients come back in (b, s, h, d) memory order. The
    kernels are deterministic, so ``deterministic`` is accepted and
    ignored; so is ``block_sizes`` (the CUDA tiles are fixed per head dim).
    Dropout as :func:`flash_attention`; S_dmask then negates the dropped
    entries.
    """
    del deterministic
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    res = flash_attention(
        qt, kt, vt, softmax_scale=softmax_scale, causal=causal,
        window_size=window_size, softcap=softcap, dropout_p=dropout_p,
        dropout_seed=dropout_seed, block_sizes=block_sizes,
        return_lse=return_attn_probs)
    if not return_attn_probs:
        return res.transpose(1, 2)
    out, lse = res
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    probs = _attn_probs_debug(qt, kt, lse, softmax_scale=scale, causal=causal,
                              window_size=window_size, softcap=softcap,
                              dropout_p=dropout_p, dropout_seed=dropout_seed)
    return out.transpose(1, 2), lse, probs


def flash_attn_qkvpacked_func(qkv, dropout_p: float = 0.0,
                              softmax_scale: Optional[float] = None,
                              causal: bool = False,
                              window_size: Tuple[int, int] = (-1, -1),
                              softcap: float = 0.0,
                              return_attn_probs: bool = False,
                              deterministic: bool = True,
                              dropout_seed=None):
    """qkv: (batch, seqlen, 3, nheads, head_dim). Returns (batch, seqlen,
    nheads, head_dim); the gradient of qkv gathers dq, dk and dv."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (b, s, 3, h, d), got {tuple(qkv.shape)}")
    return flash_attn_func(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, return_attn_probs=return_attn_probs,
        deterministic=deterministic, dropout_seed=dropout_seed)


def flash_attn_kvpacked_func(q, kv, dropout_p: float = 0.0,
                             softmax_scale: Optional[float] = None,
                             causal: bool = False,
                             window_size: Tuple[int, int] = (-1, -1),
                             softcap: float = 0.0,
                             return_attn_probs: bool = False,
                             deterministic: bool = True,
                             dropout_seed=None):
    """q: (batch, seqlen_q, nheads, head_dim); kv: (batch, seqlen_k, 2,
    nheads_k, head_dim), read in place through strides (the kernels take
    the k and v views). Returns out as :func:`flash_attn_func`."""
    if kv.dim() != 5 or kv.shape[2] != 2:
        raise ValueError(f"kv must be (b, s, 2, hk, d), got {tuple(kv.shape)}")
    return flash_attn_func(
        q, kv[:, :, 0], kv[:, :, 1], dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, return_attn_probs=return_attn_probs,
        deterministic=deterministic, dropout_seed=dropout_seed)


def flash_attn_fp8_func(q, k, v, q_descale=None, k_descale=None,
                        v_descale=None, softmax_scale: Optional[float] = None,
                        causal: bool = False,
                        window_size: Tuple[int, int] = (-1, -1),
                        softcap: float = 0.0, return_lse: bool = False):
    """FP8 (e4m3) prefill attention forward with per-(batch, KV head)
    descales (≙ the TPU package's interface.py:292-330, the FA3 fp8
    forward). q: (batch, seqlen_q, nheads, head_dim) float8_e4m3fn; k/v:
    (batch, seqlen_k, nheads_k, head_dim) float8_e4m3fn; descales (batch,
    nheads_k) fp32 or None (ones), q_descale shared by each GQA group.
    Returns out (b, sq, h, d) bf16, and with ``return_lse`` also the fp32
    (b, h, sq) logsumexp of the descaled scores. Forward only, no bias or
    dropout (``ValueError``), as in the TPU package; on the card the e4m3
    instantiation of the forward kernel (fwd.flash_fwd_fp8)."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out, lse = flash_attention_fwd(
        qt, kt, vt, sm_scale=float(softmax_scale), causal=causal,
        window_size=(int(window_size[0]), int(window_size[1])),
        softcap=float(softcap), need_lse=return_lse, q_descale=q_descale,
        k_descale=k_descale, v_descale=v_descale)
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


def _segment_ids_from_cu_seqlens(cu_seqlens, total: int):
    """seg[t] = the number of boundaries of ``cu_seqlens`` at or below t
    (``searchsorted(side="right")``, as the TPU package): token t of
    sequence i gets i + 1, and tokens past ``cu_seqlens[-1]`` get the
    sequence count + 1 on both sides. int32, on cu_seqlens' device."""
    cu = cu_seqlens.to(torch.int32)
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    return torch.searchsorted(cu, t, right=True).to(torch.int32)


def _local_positions(cu, total: int):
    """(position within its sequence, sequence index) of each packed token,
    the index clipped to the sequences (JAX interface.py:422-426)."""
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    seq = (torch.searchsorted(cu, t, right=True) - 1).clamp(0, cu.shape[0] - 2)
    return t - cu[seq], seq


def flash_attn_varlen_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                           max_seqlen_q: int, max_seqlen_k: int,
                           dropout_p: float = 0.0,
                           softmax_scale: Optional[float] = None,
                           causal: bool = False,
                           window_size: Tuple[int, int] = (-1, -1),
                           softcap: float = 0.0,
                           return_attn_probs: bool = False,
                           deterministic: bool = True,
                           dropout_seed=None,
                           return_lse: bool = False):
    """Packed variable-length attention (≙ the TPU package's
    interface.py:377): q (total_q, nheads, head_dim), k/v (total_k,
    nheads_k, head_dim), cu_seqlens_q / cu_seqlens_k (batch + 1,) int32 on
    the inputs' device. Runs as attention over a batch of 1 with segment
    ids from cu_seqlens (:func:`_segment_ids_from_cu_seqlens`) and, when
    causal or windowed, per-sequence positions aligned to the bottom right
    (query i of a sequence sees key j <= i + lk - lq), so cu_seqlens_q may
    differ from cu_seqlens_k. Everything is made on the device; nothing is
    read back. ``max_seqlen_*`` and ``deterministic`` are accepted and
    ignored. Returns out (total_q, nheads, head_dim); with ``return_lse``
    (out, lse (nheads, total_q)); with ``return_attn_probs`` (out, lse,
    S_dmask (nheads, total_q, total_k)).
    """
    del max_seqlen_q, max_seqlen_k, deterministic
    total_q, total_k = q.shape[0], k.shape[0]
    # one packing for both sides (the qkv-packed entry): made once
    same = cu_seqlens_q is cu_seqlens_k and total_q == total_k
    cu_q = cu_seqlens_q.to(device=q.device, dtype=torch.int32)
    cu_k = cu_q if same else cu_seqlens_k.to(device=q.device,
                                             dtype=torch.int32)
    q_seg = _segment_ids_from_cu_seqlens(cu_q, total_q)[None]
    k_seg = q_seg if same else \
        _segment_ids_from_cu_seqlens(cu_k, total_k)[None]
    qpos = kpos = None
    if causal or window_size[0] >= 0 or window_size[1] >= 0:
        lq_pos, q_seq = _local_positions(cu_q, total_q)
        if same:
            qpos = kpos = lq_pos[None]
        else:
            lk_pos, _ = _local_positions(cu_k, total_k)
            off = ((cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1]))[q_seq]
            qpos, kpos = (lq_pos + off)[None], lk_pos[None]
    qt, kt, vt = (t[None].transpose(1, 2) for t in (q, k, v))
    want_lse = return_attn_probs or return_lse
    res = flash_attention(
        qt, kt, vt, None, q_seg, k_seg, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap,
        dropout_p=dropout_p, dropout_seed=dropout_seed, return_lse=want_lse,
        q_positions=qpos, kv_positions=kpos)
    if not want_lse:
        return res.transpose(1, 2)[0]
    out, lse = res
    out = out.transpose(1, 2)[0]
    if not return_attn_probs:
        return out, lse[0]
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    probs = _attn_probs_debug(qt, kt, lse, softmax_scale=scale, causal=causal,
                              window_size=window_size, softcap=softcap,
                              dropout_p=dropout_p, dropout_seed=dropout_seed,
                              q_seg=q_seg, k_seg=k_seg, qpos=qpos, kpos=kpos)
    return out, lse[0], probs[0]


def flash_attn_varlen_qkvpacked_func(qkv, cu_seqlens, max_seqlen,
                                     dropout_p: float = 0.0,
                                     softmax_scale: Optional[float] = None,
                                     causal: bool = False,
                                     window_size: Tuple[int, int] = (-1, -1),
                                     softcap: float = 0.0,
                                     return_attn_probs: bool = False,
                                     deterministic: bool = True,
                                     dropout_seed=None):
    """qkv: (total, 3, nheads, head_dim), one cu_seqlens for q and k."""
    if qkv.dim() != 4 or qkv.shape[1] != 3:
        raise ValueError(f"qkv must be (total, 3, h, d), got "
                         f"{tuple(qkv.shape)}")
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens, max_seqlen,
        max_seqlen, dropout_p=dropout_p, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap,
        return_attn_probs=return_attn_probs, deterministic=deterministic,
        dropout_seed=dropout_seed)


def flash_attn_varlen_kvpacked_func(q, kv, cu_seqlens_q, cu_seqlens_k,
                                    max_seqlen_q: int, max_seqlen_k: int,
                                    dropout_p: float = 0.0,
                                    softmax_scale: Optional[float] = None,
                                    causal: bool = False,
                                    window_size: Tuple[int, int] = (-1, -1),
                                    softcap: float = 0.0,
                                    return_attn_probs: bool = False,
                                    deterministic: bool = True,
                                    dropout_seed=None):
    """kv: (total_k, 2, nheads_k, head_dim), read through the strided k and
    v views."""
    if kv.dim() != 4 or kv.shape[1] != 2:
        raise ValueError(f"kv must be (total, 2, hk, d), got "
                         f"{tuple(kv.shape)}")
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, dropout_p=dropout_p, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap,
        return_attn_probs=return_attn_probs, deterministic=deterministic,
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
