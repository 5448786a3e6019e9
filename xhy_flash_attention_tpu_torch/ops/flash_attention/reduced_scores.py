"""calc_reduced_attn_scores — per-key attention mass, recomputed from the
LSE (≙ xhy_flash_attention_tpu ops/flash_attention/reduced_scores.py).

Given q, k and the softmax LSE of an earlier attention forward,

    reduced[b, h, j] = sum_i exp(softmax_scale * (q_i . k_j) - lse_i)

is how much attention key j received in all (for attention analysis and
cache eviction). On CUDA tensors it runs in csrc/reduced_scores.cu (bf16
q/k) or in csrc/flash_fp32.cu's reduced_scores_fp32_kernel (fp32 q/k: q . k
as three TF32 products on the tensor cores), the counterparts of the TPU
kernel `_reduced_kernel` (reduced_scores.py:34, kernel #12), bitwise
deterministic; on CPU tensors in the plain version
:func:`reduced_scores_ref`. fp16 raises NotImplementedError
(:data:`common.SLICE_DTYPES`). No gradient: the TPU kernel has none
either.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from .common import SLICE_DTYPES

__all__ = ["calc_reduced_attn_scores", "reduced_scores_ref"]


def reduced_scores_ref(q, k, lse, *, sm_scale: float, causal: bool):
    """Plain version on (b, h, sq, d) q, (b, hk, sk, d) k and (b, h, sq)
    lse: the TPU kernel's arithmetic, q . k in fp32 then scaled, exp(s -
    lse) (0 on rows with lse +inf), the causal superset aligned to the
    bottom right. Returns (b, h, sk) fp32."""
    h, sq = q.shape[1], q.shape[2]
    hk, sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // hk, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        p = p.masked_fill(cols > rows + (sk - sq), 0.0)
    return p.sum(-2)


def calc_reduced_attn_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    lse: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    block_sizes=None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Reduced per-key attention scores.

    q: (b, h, sq, d); k: (b, hk, sk, d) with h % hk == 0; lse: (b, h, sq)
    fp32 as the attention forward returns it; q and k both bfloat16 or
    both float32. Returns (b, h, sk) fp32. ``causal`` restricts the sum to
    the causal region. ``block_sizes`` and ``interpret`` are the JAX
    package's TPU tiling and interpret switch and are ignored.
    ``calc_reduced_attn_scores.launches`` counts kernel launches (of either
    kernel).
    """
    del block_sizes, interpret
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if h % hk or k.shape[0] != b or k.shape[3] != d \
            or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"lse {tuple(lse.shape)}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if q.device.type == "cpu":
        return reduced_scores_ref(q, k, lse, sm_scale=softmax_scale,
                                  causal=causal)
    _cuda.require_cuda(q, k, lse)
    if q.dtype != k.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            "the CUDA reduced-scores kernels (TPU kernel #12) take bfloat16 "
            f"or float32 q/k; fp16 comes with {SLICE_DTYPES}")
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    for t, name in ((q, "q"), (k, "k")):
        _cuda.require_aligned(t, 16 // t.element_size(), name)
    lse = lse.to(torch.float32).contiguous()
    out = torch.empty(b, h, sk, dtype=torch.float32, device=q.device)
    fn = (_cuda.lib().xfa_reduced_scores_fp32 if q.dtype == torch.float32
          else _cuda.lib().xfa_reduced_scores)
    code = fn(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], b, h, hk, sq, sk, d,
        float(softmax_scale), int(causal), _cuda.stream())
    _cuda.check(code, "reduced_scores")
    calc_reduced_attn_scores.launches += 1
    return out


calc_reduced_attn_scores.launches = 0
