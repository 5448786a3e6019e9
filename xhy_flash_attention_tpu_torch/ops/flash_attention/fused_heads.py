"""Attention on the packed projection layout (≙ xhy_flash_attention_tpu
ops/flash_attention/fused_heads.py), forward.

q/k/v stay in the projection layout (b, s, h*d) — as (b, s, h, d) views or
as column ranges of one packed (b, s, (h + 2hk)*d) Wqkv output — and the
kernel csrc/flash_fwd.cu reads them through strides, with no slice or
transpose copy. It is the counterpart of the TPU kernel `_fwd_kernel`
(fused_heads.py:59) and shares its CUDA source with fwd.py; the launch is
counted here, apart from flash_attention_fwd's. On a CPU tensor the plain
version :func:`fused_heads_fwd_ref` runs.

Scope, as in the TPU package: sq == sk <= MAX_SEQ, causal or full, softcap,
MQA/GQA; no bias, windows or segments. Dropout comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import NEXT_SLICES, require_inference
from .fwd import attention_fwd_ref, launch_flash_fwd

__all__ = [
    "MAX_SEQ",
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


def fused_heads_fwd_ref(q, k, v, *, sm_scale: float, causal: bool,
                        softcap: float):
    """Plain version on (b, s, h, d) / (b, s, hk, d) views; returns
    (b, s, h, d)."""
    out, _ = attention_fwd_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        sm_scale=sm_scale, causal=causal, softcap=softcap, need_lse=False)
    return out.transpose(1, 2)


def fused_heads_fwd(q, k, v, *, sm_scale: float, causal: bool,
                    softcap: float):
    """Kernel wrapper on (b, s, h, d) / (b, s, hk, d) views of the
    projection layout. Returns a contiguous (b, s, h, d) tensor.

    ``fused_heads_fwd.launches`` counts kernel launches.
    """
    require_inference(q, k, v)
    if q.device.type == "cpu":
        return fused_heads_fwd_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                   softcap=softcap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_flash_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     out.transpose(1, 2), None, sm_scale=sm_scale,
                     causal=causal, softcap=softcap)
    fused_heads_fwd.launches += 1
    return out


fused_heads_fwd.launches = 0


def _check(dropout_p):
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout in packed attention comes with slice 3 (Training) "
            f"{NEXT_SLICES}")


def packed_heads_attention(q, k, v, *, softmax_scale: Optional[float] = None,
                           causal: bool = False, softcap: float = 0.0,
                           dropout_p: float = 0.0, dropout_seed=None):
    """Attention on (b, s, h, d) inputs without layout transposes. Returns
    (b, s, h, d). The caller checks :func:`packed_heads_supported` first."""
    _check(dropout_p)
    d = q.shape[-1]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    return fused_heads_fwd(q, k, v, sm_scale=float(softmax_scale),
                           causal=causal, softcap=float(softcap))


def packed_qkv_attention(qkv, *, num_heads: int, num_heads_kv: int,
                         head_dim: int, softmax_scale: Optional[float] = None,
                         causal: bool = False, softcap: float = 0.0,
                         dropout_p: float = 0.0, dropout_seed=None):
    """Attention directly on the packed Wqkv output (b, s, (h + 2hk)*d) in
    [q | k | v] column order. Returns (b, s, h*d), ready for out_proj."""
    _check(dropout_p)
    h, hk, d = num_heads, num_heads_kv, head_dim
    b, s, w = qkv.shape
    if w != (h + 2 * hk) * d:
        raise ValueError(f"packed width {w} != (h + 2hk) * d = "
                         f"{(h + 2 * hk) * d}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    q = qkv[..., : h * d].view(b, s, h, d)
    k = qkv[..., h * d: (h + hk) * d].view(b, s, hk, d)
    v = qkv[..., (h + hk) * d:].view(b, s, hk, d)
    out = fused_heads_fwd(q, k, v, sm_scale=float(softmax_scale),
                          causal=causal, softcap=float(softcap))
    return out.reshape(b, s, h * d)
