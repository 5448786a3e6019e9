"""Embeddings (≙ xhy_flash_attention_tpu modules/embedding.py)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["GPT2Embeddings"]


class GPT2Embeddings(nn.Module):
    """Word embeddings plus optional learned positions
    (max_position_embeddings == 0 means rotary-only models)."""

    def __init__(self, embed_dim: int, vocab_size: int,
                 max_position_embeddings: int = 0, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, embed_dim,
                                            dtype=dtype, device=device)
        self.position_embeddings = (
            nn.Embedding(max_position_embeddings, embed_dim, dtype=dtype,
                         device=device)
            if max_position_embeddings > 0 else None)

    def forward(self, input_ids, position_ids=None, seqlen_offset=0):
        """seqlen_offset: int, or (b,) tensor of per-sample offsets."""
        x = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                s = input_ids.shape[1]
                position_ids = torch.arange(s, device=input_ids.device)
                if isinstance(seqlen_offset, torch.Tensor):
                    seqlen_offset = seqlen_offset.to(input_ids.device)
                    if seqlen_offset.ndim == 1:
                        seqlen_offset = seqlen_offset[:, None]
                position_ids = position_ids + seqlen_offset
            x = x + self.position_embeddings(position_ids)
        return x
