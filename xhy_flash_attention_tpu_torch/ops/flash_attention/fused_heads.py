"""Attention on the packed projection layout (≙ xhy_flash_attention_tpu
ops/flash_attention/fused_heads.py), forward and backward.

q/k/v stay in the projection layout (b, s, h*d) — as (b, s, h, d) views or
as column ranges of one packed (b, s, (h + 2hk)*d) Wqkv output — and the
kernels read them through strides, with no slice or transpose copy. The
forward runs csrc/flash_fwd.cu (the counterpart of the TPU kernel
`_fwd_kernel`, fused_heads.py:59); the backward (≙ `_bwd_kernel`,
fused_heads.py:105) runs the pre-pass and the dK/dV and dQ kernels of
csrc/flash_bwd.cu, which write dq/dk/dv through strides:
`packed_qkv_attention`'s gradient is one packed dqkv in [dq | dk | dv]
column order, as `_bwd_call_qkv` emits it (fused_heads.py:400-429), with no
concatenation. float32 views run csrc/flash_fp32.cu's forward and backward
(every product as three TF32 products on the tensor cores) through the same
launchers (fwd.launch_flash_fwd, bwd.launch_flash_bwd).
Launches are counted here, apart from flash_attention_fwd's,
the pre-pass's and the dK/dV and dQ entries'. On CPU
tensors the plain versions :func:`fused_heads_fwd_ref` and
:func:`fused_heads_bwd_ref` run.

Scope, as in the TPU package: sq == sk <= MAX_SEQ, causal or full, softcap,
MQA/GQA, dropout (the kernels' dropout instantiations, the salt of batch
row b and query head i being b * h + i as in the TPU package's
fused_heads.py:86-87); no bias, windows or segments.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from .bwd import attention_bwd_ref, flash_bwd_prep, launch_flash_bwd
from .common import Dropout
from .fwd import attention_fwd_ref, check_supported, launch_flash_fwd
from .remat import saved_attention

__all__ = [
    "MAX_SEQ",
    "fused_heads_bwd",
    "fused_heads_bwd_ref",
    "fused_heads_fwd",
    "fused_heads_fwd_ref",
    "packed_heads_attention",
    "packed_heads_supported",
    "packed_qkv_attention",
]

MAX_SEQ = 1024


def _supported(b, s, h, d, hk, causal, window_size, softcap, bias,
               q_seg, kv_seg):
    return (
        s <= MAX_SEQ
        and (h * d) % 128 == 0
        and (hk * d) % 128 == 0
        and h % hk == 0
        and window_size == (-1, -1)
        and bias is None and q_seg is None and kv_seg is None
    )


def packed_heads_supported(q_shape, k_shape, *, causal, window_size,
                           softcap, bias=None, q_seg=None, kv_seg=None):
    """The TPU package's routing gate (fused_heads.py:47-56), unchanged."""
    b, s, h, d = q_shape
    sk, hk = k_shape[1], k_shape[2]
    return s == sk and _supported(
        b, s, h, d, hk, causal, tuple(window_size), softcap, bias,
        q_seg, kv_seg)


def _bhsd(*ts):
    return [t.transpose(1, 2) for t in ts]


def fused_heads_fwd_ref(q, k, v, *, sm_scale: float, causal: bool,
                        softcap: float, need_lse: bool = False,
                        dropout: Optional[Dropout] = None):
    """Plain version on (b, s, h, d) / (b, s, hk, d) views; returns
    (b, s, h, d), and with ``need_lse`` also the fp32 (b, h, s) LSE."""
    out, lse = attention_fwd_ref(
        *_bhsd(q, k, v), sm_scale=sm_scale, causal=causal, softcap=softcap,
        need_lse=need_lse, dropout=dropout)
    out = out.transpose(1, 2)
    return (out, lse) if need_lse else out


def fused_heads_fwd(q, k, v, *, sm_scale: float, causal: bool,
                    softcap: float, need_lse: bool = False,
                    dropout: Optional[Dropout] = None):
    """Kernel wrapper on (b, s, h, d) / (b, s, hk, d) views of the
    projection layout. Returns a contiguous (b, s, h, d) tensor, and with
    ``need_lse`` also the fp32 (b, h, s) LSE. ``dropout``: a
    :class:`common.Dropout` or None.

    ``fused_heads_fwd.launches`` counts kernel launches.
    """
    kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
              dropout=dropout)
    if q.device.type == "cpu":
        return fused_heads_fwd_ref(q, k, v, need_lse=need_lse, **kw)
    b, s, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if need_lse else None)
    launch_flash_fwd(*_bhsd(q, k, v, out), lse, **kw)
    fused_heads_fwd.launches += 1
    return (out, lse) if need_lse else out


fused_heads_fwd.launches = 0


def fused_heads_bwd_ref(q, k, v, out, lse, do, *, sm_scale: float,
                        causal: bool, softcap: float, dq=None, dk=None,
                        dv=None, dropout: Optional[Dropout] = None):
    """Plain version of :func:`fused_heads_bwd`: the same gradients from
    `attention_bwd_ref`, copied into dq/dk/dv where they are given."""
    grads = attention_bwd_ref(*_bhsd(q, k, v, out), lse, do.transpose(1, 2),
                              sm_scale=sm_scale, causal=causal,
                              softcap=softcap, dropout=dropout)
    grads = [g.transpose(1, 2) for g in grads]
    for dst, g in zip((dq, dk, dv), grads):
        if dst is not None:
            dst.copy_(g)
    return tuple(g if dst is None else dst
                 for dst, g in zip((dq, dk, dv), grads))


def fused_heads_bwd(q, k, v, out, lse, do, *, sm_scale: float, causal: bool,
                    softcap: float, dq=None, dk=None, dv=None,
                    dropout: Optional[Dropout] = None):
    """Backward of the packed-layout attention on (b, s, h, d) / (b, s, hk,
    d) views: q/k/v and out of the forward, its fp32 (b, h, s) LSE and the
    output gradient do. dq/dk/dv, where given, are (b, s, ·, d) views to
    write (column ranges of a packed dqkv); the others are allocated.
    ``dropout``: the forward's :class:`common.Dropout` or None. Returns
    (dq, dk, dv).

    ``fused_heads_bwd.launches`` counts its entries on CUDA (each runs the
    pre-pass, counted by ``bwd.flash_bwd_prep.launches``, then the dK/dV
    and the dQ kernel).
    """
    kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
              dropout=dropout)
    if q.device.type == "cpu":
        return fused_heads_bwd_ref(q, k, v, out, lse, do, dq=dq, dk=dk,
                                   dv=dv, **kw)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
        if dq is None else dq
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device) \
        if dk is None else dk
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device) \
        if dv is None else dv
    do = _cuda.aligned(do, 8)
    qt, kt, vt, dot, ot = _bhsd(q, k, v, do, out)
    qs, delta = flash_bwd_prep(qt, ot, dot, sm_scale=sm_scale)
    args = (qs, kt, vt, dot, lse, delta, *_bhsd(dq, dk, dv))
    launch_flash_bwd("dkv", *args, **kw)
    launch_flash_bwd("dq", *args, **kw)
    fused_heads_bwd.launches += 1
    return dq, dk, dv


fused_heads_bwd.launches = 0


class _PackedHeads(torch.autograd.Function):
    """(b, s, h, d) q and (b, s, hk, d) k/v -> (b, s, h, d)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, softcap, dropout):
        ctx.kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
                      dropout=dropout)
        out, lse = saved_attention(lambda: fused_heads_fwd(
            q, k, v, need_lse=True, **ctx.kw), q)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_heads_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _split(qkv, h, hk, d):
    b, s, _ = qkv.shape
    return (qkv[..., : h * d].view(b, s, h, d),
            qkv[..., h * d: (h + hk) * d].view(b, s, hk, d),
            qkv[..., (h + hk) * d:].view(b, s, hk, d))


class _PackedQKV(torch.autograd.Function):
    """(b, s, (h + 2hk) d) packed qkv -> (b, s, h d); the gradient is one
    packed dqkv."""

    @staticmethod
    def forward(ctx, qkv, h, hk, d, sm_scale, causal, softcap, dropout):
        ctx.kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
                      dropout=dropout)
        ctx.heads = (h, hk, d)
        out, lse = saved_attention(lambda: fused_heads_fwd(
            *_split(qkv, h, hk, d), need_lse=True, **ctx.kw), qkv)
        b, s = qkv.shape[:2]
        out = out.reshape(b, s, h * d)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        h, hk, d = ctx.heads
        b, s = qkv.shape[:2]
        dqkv = torch.empty_like(qkv)
        fused_heads_bwd(*_split(qkv, h, hk, d), out.view(b, s, h, d), lse,
                        dout.reshape(b, s, h, d), **ctx.kw,
                        **dict(zip(("dq", "dk", "dv"),
                                   _split(dqkv, h, hk, d))))
        return dqkv, None, None, None, None, None, None, None


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def packed_heads_attention(q, k, v, *, softmax_scale: Optional[float] = None,
                           causal: bool = False, softcap: float = 0.0,
                           dropout_p: float = 0.0, dropout_seed=None):
    """Attention on (b, s, h, d) inputs without layout transposes. Returns
    (b, s, h, d); differentiable in q, k and v. The caller checks
    :func:`packed_heads_supported` first. dropout_p > 0 needs
    ``dropout_seed`` (as interface.flash_attention)."""
    check_supported(q, None, dropout_p, "packed_heads_attention")
    d = q.shape[-1]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    kw = dict(sm_scale=float(softmax_scale), causal=bool(causal),
              softcap=float(softcap),
              dropout=Dropout.make(dropout_p, dropout_seed))
    if _needs_grad(q, k, v):
        return _PackedHeads.apply(q, k, v, *kw.values())
    return fused_heads_fwd(q, k, v, **kw)


def packed_qkv_attention(qkv, *, num_heads: int, num_heads_kv: int,
                         head_dim: int, softmax_scale: Optional[float] = None,
                         causal: bool = False, softcap: float = 0.0,
                         dropout_p: float = 0.0, dropout_seed=None):
    """Attention directly on the packed Wqkv output (b, s, (h + 2hk)*d) in
    [q | k | v] column order. Returns (b, s, h*d), ready for out_proj;
    differentiable in qkv, whose gradient comes back packed. dropout_p > 0
    needs ``dropout_seed``."""
    check_supported(qkv, None, dropout_p, "packed_qkv_attention")
    h, hk, d = num_heads, num_heads_kv, head_dim
    b, s, w = qkv.shape
    if w != (h + 2 * hk) * d:
        raise ValueError(f"packed width {w} != (h + 2hk) * d = "
                         f"{(h + 2 * hk) * d}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    kw = dict(sm_scale=float(softmax_scale), causal=bool(causal),
              softcap=float(softcap),
              dropout=Dropout.make(dropout_p, dropout_seed))
    if _needs_grad(qkv):
        return _PackedQKV.apply(qkv, h, hk, d, *kw.values())
    return fused_heads_fwd(*_split(qkv, h, hk, d), **kw).reshape(b, s, h * d)
