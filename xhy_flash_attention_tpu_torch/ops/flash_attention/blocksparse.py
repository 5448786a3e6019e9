"""Block-sparse flash attention (≙ xhy_flash_attention_tpu
ops/flash_attention/blocksparse.py).

A 0/1 block mask at a granularity (gq, gk), multiples of 128 as in the JAX
package, turns (query block, key block) pairs on or off. On CUDA tensors the
forward and both backward kernels read the mask at its own granularity and
skip every off tile before loading it (the kernels' tiles of 32 or 64 divide
any such block); on CPU tensors the plain versions apply the dense mask.
Combines with causal masking and dropout (the kernels' masked dropout
instantiations).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import block_keep_mask, cdiv
from .fwd import check_supported
from .interface import attention

__all__ = [
    "blocksparse_attention",
    "blockmask_to_dense",
    "flash_blocksparse_attn_func",
]


def _pair(block_size) -> Tuple[int, int]:
    if isinstance(block_size, int):
        return block_size, block_size
    return int(block_size[0]), int(block_size[1])


def blocksparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask: torch.Tensor,
    *,
    block_size: Tuple[int, int] | int = (256, 256),
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
):
    """Block-sparse attention on (b, h, s, d) inputs.

    block_mask: (b|1, hm|1, ceil(sq/gq), ceil(sk/gk)) 0/1, or a 2-D mask
    shared by every batch element and head; an off block is skipped entirely.
    Granularities must be multiples of 128. Differentiable in q, k, v.
    dropout_p > 0 needs ``dropout_seed`` (as interface.flash_attention).
    """
    gq, gk = _pair(block_size)
    if gq % 128 or gk % 128:
        raise ValueError(f"block_size must be multiples of 128, got {block_size}")
    check_supported(q, None, dropout_p, "blocksparse_attention")
    sq, sk = q.shape[2], k.shape[2]
    bm = torch.as_tensor(block_mask, device=q.device).to(torch.int32)
    if bm.dim() == 2:
        bm = bm[None, None]
    expect = (cdiv(sq, gq), cdiv(sk, gk))
    if tuple(bm.shape[2:]) != expect:
        raise ValueError(f"block_mask {tuple(bm.shape[2:])} != expected {expect}")
    return attention(q, k, v, softmax_scale=softmax_scale, causal=causal,
                     masks=dict(block_mask=(bm, gq, gk)),
                     dropout_p=dropout_p, dropout_seed=dropout_seed)


def blockmask_to_dense(block_mask: torch.Tensor, seqlen_q: int, seqlen_k: int,
                       block_size: Tuple[int, int] | int) -> torch.Tensor:
    """Expand a block mask to a dense (b|1, hm, sq, sk) boolean mask (True =
    attend)."""
    gq, gk = _pair(block_size)
    bm = torch.as_tensor(block_mask)
    if bm.dim() == 2:
        bm = bm[None, None]
    return block_keep_mask(bm, gq, gk, seqlen_q, seqlen_k)


def flash_blocksparse_attn_func(
    qkv: torch.Tensor,
    block_mask: torch.Tensor,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    *,
    block_size: Tuple[int, int] | int = (256, 256),
    dropout_seed=None,
):
    """The reference's packed form: qkv (b, s, 3, h, d). Returns (b, s, h,
    d). The head swaps are strided views; the kernels read them in place."""
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = blocksparse_attention(
        q, k, v, block_mask, block_size=block_size, causal=causal,
        softmax_scale=softmax_scale, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    return out.transpose(1, 2)
