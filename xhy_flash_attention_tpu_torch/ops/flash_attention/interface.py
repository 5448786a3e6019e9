"""Public flash-attention API, forward (≙ xhy_flash_attention_tpu
ops/flash_attention/interface.py).

Inference only in this slice: an input that requires grad raises (the
backward kernels come with the training slice).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from .fwd import flash_attention_fwd

__all__ = ["flash_attention", "flash_attn_func"]


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
    (b, h, sq).
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_fwd(
        q, k, v, bias, q_segment_ids, kv_segment_ids,
        sm_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, dropout_p=dropout_p, dropout_seed=dropout_seed,
        need_lse=return_lse, q_positions=q_positions,
        kv_positions=kv_positions)
    return (out, lse) if return_lse else out


def flash_attn_func(q, k, v, dropout_p: float = 0.0,
                    softmax_scale: Optional[float] = None,
                    causal: bool = False,
                    window_size: Tuple[int, int] = (-1, -1),
                    softcap: float = 0.0,
                    deterministic: bool = True,
                    dropout_seed=None):
    """q: (batch, seqlen_q, nheads, head_dim); k/v: (batch, seqlen_k,
    nheads_k, head_dim). Returns out in the same layout.

    The layout swaps are views: the kernel reads strided inputs, and the
    output comes back in (b, s, h, d) memory order. The kernel is
    deterministic, so ``deterministic`` is accepted and ignored.
    """
    del deterministic
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, dropout_p=dropout_p, dropout_seed=dropout_seed)
    return out.transpose(1, 2)
