"""Varlen packing utilities (≙ xhy_flash_attention_tpu bert_padding.py).

`unpad_input` turns a padded batch (b, s, ...) and an attention mask into
a packed (total, ...) tensor with `cu_seqlens`; `pad_input` is the inverse.
The layout is the TPU package's: the packed buffer keeps the padded
capacity (total = b * s, or ``static_total``) with the valid tokens packed
to the front and zeros after them, so that every shape is known without
reading the mask on the host; the attention kernels mask the tail through
the segment ids (`flash_attn_varlen_func` gives tokens past
``cu_seqlens[-1]`` an id of their own). PyTorch's indexing is
differentiable, so no autograd function is needed. Plain PyTorch, on the
inputs' device; nothing is read back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["index_first_axis", "index_first_axis_residual",
           "index_put_first_axis", "pad_input", "unpad_input"]


def index_first_axis(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` of a flattened (b * s, ...) tensor."""
    return x.index_select(0, indices.long())


def index_put_first_axis(values: torch.Tensor, indices: torch.Tensor,
                         first_axis_dim: int) -> torch.Tensor:
    """``values`` scattered into rows ``indices`` of zeros((first_axis_dim,
    ...))."""
    out = values.new_zeros((first_axis_dim,) + tuple(values.shape[1:]))
    return out.index_put((indices.long(),), values)


def index_first_axis_residual(x: torch.Tensor, indices: torch.Tensor):
    """(rows ``indices`` of x, x): the gathered rows and the whole tensor
    as a residual (autograd sums both gradients)."""
    return index_first_axis(x, indices), x


def unpad_input(hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                static_total: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """hidden_states (batch, seqlen, ...), attention_mask (batch, seqlen)
    bool or int, 1 = valid. Returns (packed, indices, cu_seqlens,
    max_seqlen_in_batch, segment_ids):

    - packed (total, ...): the valid tokens front-packed in batch order
      (total = b * s, or ``static_total``), zeros after them;
    - indices (total,) int32: each packed row's index in the flattened
      input; with total = b * s a permutation (valid positions first), so
      :func:`pad_input` inverts exactly;
    - cu_seqlens (batch + 1,) int32; max_seqlen_in_batch a 0-d int32
      tensor; segment_ids (total,) int32: 1 + the row's batch index, 0 for
      the tail.
    """
    b, s = attention_mask.shape
    mask = attention_mask.to(torch.bool)
    seqlens = mask.sum(-1, dtype=torch.int32)
    cu_seqlens = torch.cat([seqlens.new_zeros(1),
                            torch.cumsum(seqlens, 0, dtype=torch.int32)])
    total = static_total if static_total is not None else b * s
    flat = mask.reshape(-1)
    order = torch.argsort((~flat).to(torch.int8), stable=True)
    indices = order[:total].to(torch.int32)
    x = hidden_states.reshape((b * s,) + tuple(hidden_states.shape[2:]))
    valid = flat[indices.long()]
    packed = index_first_axis(x, indices)
    packed = torch.where(valid.reshape((-1,) + (1,) * (packed.dim() - 1)),
                         packed, torch.zeros_like(packed))
    rows = torch.arange(1, b + 1, dtype=torch.int32, device=mask.device)
    seg = rows[:, None].expand(b, s).reshape(-1)[indices.long()]
    segment_ids = torch.where(valid, seg, torch.zeros_like(seg))
    return packed, indices, cu_seqlens, seqlens.max(), segment_ids


def pad_input(packed: torch.Tensor, indices: torch.Tensor, batch: int,
              seqlen: int) -> torch.Tensor:
    """The inverse of :func:`unpad_input`: (batch, seqlen, ...)."""
    out = index_put_first_axis(packed, indices, batch * seqlen)
    return out.reshape((batch, seqlen) + tuple(packed.shape[1:]))
