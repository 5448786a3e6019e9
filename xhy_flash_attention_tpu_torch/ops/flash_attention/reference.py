"""Plain PyTorch reference attention for the numerics contract (≙
xhy_flash_attention_tpu ops/flash_attention/reference.py).

``attention_ref(..., upcast=True)`` is fp32 ground truth;
``attention_ref(..., upcast=False, reorder_ops=True)`` is the deliberately
low-precision baseline. A kernel passes when
``|out - ref| <= 2 * |out_lowprec - ref|`` (plus a small atol).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "construct_local_mask"]


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size: Tuple[int, int] = (-1, -1),
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Boolean mask (True = masked out) for causal / sliding-window
    attention, with the causal diagonal aligned to the bottom right: row i
    sees columns [i + sk - sq - left, i + sk - sq + right]."""
    row_idx = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col_idx = torch.arange(seqlen_k, dtype=torch.int64, device=device)[None, :]
    if key_padding_mask is None:
        sk = seqlen_k
    else:
        sk = key_padding_mask.sum(-1)[:, None, None, None]
    if query_padding_mask is None:
        sq = seqlen_q
    else:
        sq = query_padding_mask.sum(-1)[:, None, None, None]
    left, right = window_size
    if left < 0 and right < 0:
        return torch.zeros((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
    masks = []
    if right >= 0:
        masks.append(col_idx > row_idx + sk - sq + right)
    if left >= 0:
        masks.append(col_idx < row_idx + sk - sq - left)
    mask = masks[0]
    for m in masks[1:]:
        mask = mask | m
    return mask


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    reorder_ops: bool = False,
):
    """q: (b, sq, h, d); k/v: (b, sk, hk, d), h % hk == 0.

    Returns (out (b, sq, h, d), attention probabilities (b, h, sq, sk)).
    """
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        if attn_bias is not None:
            attn_bias = attn_bias.float()
    batch, seqlen_q, nheads, head_dim = q.shape
    seqlen_k, nheads_k = k.shape[1], k.shape[2]
    if nheads % nheads_k:
        raise ValueError(f"{nheads} heads do not group over {nheads_k}")
    if nheads_k != nheads:
        k = k.repeat_interleave(nheads // nheads_k, dim=2)
        v = v.repeat_interleave(nheads // nheads_k, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(head_dim)
    if not reorder_ops:
        scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if attn_bias is not None:
        scores = scores + attn_bias
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :], -math.inf)
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, query_padding_mask,
            key_padding_mask, device=q.device)
        scores = scores.masked_fill(local_mask, -math.inf)
    # rows with no visible key give 0 output and 0 probabilities
    row_max = scores.amax(-1, keepdim=True)
    row_max = torch.clamp_min(row_max, torch.finfo(scores.dtype).min)
    unnorm = torch.exp(scores - row_max)
    unnorm = torch.where(torch.isneginf(scores), 0.0, unnorm)
    denom = unnorm.sum(-1, keepdim=True)
    attention = torch.where(
        denom == 0.0, 0.0, unnorm / torch.clamp_min(denom, 1e-30))
    if local_mask is not None:
        all_masked = local_mask.all(-1, keepdim=True)
        attention = torch.where(all_masked, 0.0, attention)
    dropout_scaling = 1.0 / (1.0 - dropout_p)
    attention_drop = attention if dropout_mask is None else torch.where(
        dropout_mask, attention, 0.0)
    output = torch.einsum("bhts,bshd->bthd", attention_drop,
                          v * dropout_scaling)
    if query_padding_mask is not None:
        output = output.masked_fill(~query_padding_mask[:, :, None, None], 0.0)
        attention = attention.masked_fill(
            ~query_padding_mask[:, None, :, None], 0.0)
    return output.to(dtype_og), attention.to(dtype_og)
