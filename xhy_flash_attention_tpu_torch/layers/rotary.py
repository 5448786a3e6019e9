"""Rotary position embeddings (≙ xhy_flash_attention_tpu layers/rotary.py).

Plain PyTorch: the rotation is elementwise work next to the projections.
Both layouts: GPT-NeoX "block" (non-interleaved) and GPT-J interleaved;
partial rotary when cos/sin cover fewer dims than the head.
"""

from __future__ import annotations

import torch

__all__ = ["apply_rotary_emb", "RotaryEmbedding"]


def _rotate(x, cos, sin, interleaved: bool):
    """x: (b, s, h, d_ro) fp32; cos/sin: (s, d_ro / 2) fp32."""
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    if not interleaved:
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def apply_rotary_emb(x, cos, sin, interleaved: bool = False):
    """x: (batch, seqlen, nheads, head_dim); cos/sin: (seqlen, rotary_dim/2).

    The rotation runs in fp32 and the result returns in x's dtype.
    """
    ro_dim = cos.shape[-1] * 2
    x_ro = _rotate(x[..., :ro_dim].float(), cos.float(), sin.float(),
                   interleaved).to(x.dtype)
    if ro_dim == x.shape[-1]:
        return x_ro
    return torch.cat([x_ro, x[..., ro_dim:]], dim=-1)


class RotaryEmbedding:
    """cos/sin tables at absolute positions (≙ RotaryEmbedding of the TPU
    package; xPos scaling is not ported)."""

    def __init__(self, dim: int, base: float = 10000.0):
        self.dim = dim
        self.base = float(base)

    def _inv_freq(self, device):
        return 1.0 / (self.base ** (
            torch.arange(0, self.dim, 2, dtype=torch.float32, device=device)
            / self.dim))

    def cos_sin(self, seqlen: int, dtype=torch.float32, offset: int = 0,
                device=None):
        """(cos, sin) of shape (seqlen, dim / 2) for positions
        offset .. offset + seqlen - 1, cast to ``dtype`` as the TPU package
        does."""
        t = torch.arange(offset, offset + seqlen, dtype=torch.float32,
                         device=device)
        freqs = torch.outer(t, self._inv_freq(device))
        return freqs.cos().to(dtype), freqs.sin().to(dtype)
