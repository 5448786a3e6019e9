"""FlashMask — column-wise sparse attention masks (≙ xhy_flash_attention_tpu
ops/flash_attention/flashmask.py).

Instead of an O(s²) dense mask, each key column carries up to four row
indices (LTStart/LTEnd/UTStart/UTEnd) describing half-open masked row bands

  lower band: rows in [LTStart[c], LTEnd[c]) are masked,
  upper band: rows in [UTStart[c], UTEnd[c]) are masked.

Accepted encodings of ``startend_row_indices`` (b, hm, seqlen_k, NV), as in
the JAX package:

  causal=True,  NV=1: [LTStart]                        (LTEnd = seqlen)
  causal=True,  NV=2: [LTStart, LTEnd]
  causal=False, NV=2: [LTStart, UTEnd]                 (bands reach the edges)
  causal=False, NV=4: [LTStart, LTEnd, UTStart, UTEnd]

hm divides the number of query heads (1 = one mask for all heads). On CUDA
tensors the forward and both backward kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) skip key tiles that are masked for a whole query tile and
bypass the band test on tiles masked nowhere, from per-tile max/min of the
vectors; on CPU tensors the plain versions apply the dense mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import fm_banned, fm_mode_for
from .interface import attention

__all__ = [
    "flashmask_attention",
    "flashmask_to_dense",
    "causal_document_mask",
    "sliding_window_mask",
    "global_sliding_window_mask",
]


def flashmask_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    startend_row_indices: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_sizes=None,
    return_lse: bool = False,
):
    """Sparse-mask flash attention on (b, h, s, d) inputs.

    startend_row_indices: (b, hm, seqlen_k, NV) int, see the module
    docstring. Differentiable in q, k, v. Returns out (and the fp32 lse,
    which carries no gradient, with ``return_lse``). ``block_sizes`` is the
    JAX package's TPU tiling and is ignored: the kernels own their tiles.
    """
    del block_sizes
    sk = k.shape[2]
    idx = torch.as_tensor(startend_row_indices, device=q.device)
    if idx.dim() != 4:
        raise ValueError("startend_row_indices must be (b, hm, seqlen_k, NV), "
                         f"got {tuple(idx.shape)}")
    mode = fm_mode_for(causal, idx.shape[-1])
    if idx.shape[2] != sk:
        raise ValueError(f"mask seqlen {idx.shape[2]} != key seqlen {sk}")
    vecs = idx.movedim(-1, 2).to(torch.int32)  # (b, hm, NV, sk)
    return attention(q, k, v, softmax_scale=softmax_scale, causal=causal,
                     return_lse=return_lse,
                     masks=dict(flashmask_vecs=vecs, flashmask_mode=mode))


# ---------------------------------------------------------------------------
# Dense form and constructors (the same integer arithmetic as the JAX
# package's, so the indices agree bit for bit)
# ---------------------------------------------------------------------------

def flashmask_to_dense(startend_row_indices: torch.Tensor, seqlen_q: int,
                       causal: bool) -> torch.Tensor:
    """The dense boolean mask (True = attend), (b, hm, sq, sk), that the
    indices describe; with ``causal`` also key j > row i is masked (the top
    left aligned causal mask of the JAX package's utility)."""
    idx = torch.as_tensor(startend_row_indices).to(torch.int32)
    b, hm, sk, nv = idx.shape
    mode = fm_mode_for(causal, nv)
    rows = torch.arange(seqlen_q, dtype=torch.int32, device=idx.device)[:, None]
    banned = fm_banned(mode, idx.movedim(-1, 2), rows)
    if causal:
        cols = torch.arange(sk, dtype=torch.int32, device=idx.device)[None, :]
        banned = banned | (cols > rows)
    return ~banned


def causal_document_mask(doc_ids: torch.Tensor) -> torch.Tensor:
    """Causal document (block-diagonal) mask: token i attends to j <= i in
    the same document. doc_ids: (b, s) int labels. Returns (b, 1, s, 1)
    int32 indices for causal=True: LTStart[c] is one past the last position
    of c's document."""
    b, s = doc_ids.shape
    pos = torch.arange(s, dtype=torch.int32, device=doc_ids.device)
    same = doc_ids[:, None, :] == doc_ids[:, :, None]  # (b, s, s)
    last_same = torch.where(same, pos, -1).amax(-1)
    return (last_same + 1).to(torch.int32)[:, None, :, None]


def sliding_window_mask(batch: int, seqlen: int, window: int, *,
                        device="cuda") -> torch.Tensor:
    """Causal sliding window: token i attends to [i - window + 1, i].
    Returns (b, 1, s, 1) int32 indices for causal=True."""
    c = torch.arange(seqlen, dtype=torch.int32, device=device)
    lts = torch.clamp(c + window, max=seqlen)
    return lts[None, None, :, None].expand(batch, 1, seqlen, 1)


def global_sliding_window_mask(batch: int, seqlen: int, window: int,
                               num_global: int, *,
                               device="cuda") -> torch.Tensor:
    """Sliding window plus global prefix tokens (Longformer-style), causal.
    Returns (b, 1, s, 2) int32 indices for causal=True."""
    c = torch.arange(seqlen, dtype=torch.int32, device=device)
    lts = torch.where(c < num_global, seqlen, torch.clamp(c + window,
                                                          max=seqlen))
    lte = torch.full((seqlen,), seqlen, dtype=torch.int32, device=device)
    idx = torch.stack([lts.to(torch.int32), lte], dim=-1)
    return idx[None, None].expand(batch, 1, seqlen, 2)
