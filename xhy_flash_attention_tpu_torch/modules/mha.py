"""Multi-head attention with a dense KV cache (≙ xhy_flash_attention_tpu
modules/mha.py `MHA`).

Routing follows the TPU package (mha.py:285-377):
  * no cache, no rotary, h == hk: attention straight on the packed Wqkv
    output (packed_qkv_attention) when the packed gate allows;
  * prefill (seqlen_offset == 0) and calls without a cache: `_attend`, which
    takes the packed-heads kernel when supported, else flash_attention;
  * decode (seqlen_offset > 0): decode_attention against the cache at
    lengths offset + sq.

The TPU package returns a new cache; here the (b, hk, max_seqlen, d)
caches are written in place and the same tensors are returned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..layers.rotary import RotaryEmbedding, apply_rotary_emb
from ..ops.decode import decode_attention
from ..ops.flash_attention.fused_heads import (
    packed_heads_attention,
    packed_heads_supported,
    packed_qkv_attention,
)
from ..ops.flash_attention.interface import flash_attention
from .linear import RowParallelDense

__all__ = ["MHA"]


class MHA(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_heads_kv: Optional[int] = None,
        head_dim: Optional[int] = None,
        qkv_proj_bias: bool = True,
        out_proj_bias: bool = True,
        softmax_scale: Optional[float] = None,
        causal: bool = False,
        window_size: Tuple[int, int] = (-1, -1),
        softcap: float = 0.0,
        rotary_emb_dim: int = 0,
        rotary_emb_base: float = 10000.0,
        rotary_emb_interleaved: bool = False,
        *,
        dtype=torch.float32,
        device="cuda",
    ):
        super().__init__()
        h = num_heads
        hk = num_heads_kv if num_heads_kv is not None else h
        if h % hk:
            raise ValueError(f"{h} heads do not group over {hk} KV heads")
        d = head_dim if head_dim is not None else embed_dim // h
        self.h, self.hk, self.d = h, hk, d
        self.softmax_scale = softmax_scale
        self.causal = causal
        self.window_size = tuple(window_size)
        self.softcap = softcap
        self.rotary_emb_dim = rotary_emb_dim
        self.rotary_emb_interleaved = rotary_emb_interleaved
        self.Wqkv = nn.Linear(embed_dim, (h + 2 * hk) * d, bias=qkv_proj_bias,
                              dtype=dtype, device=device)
        self.out_proj = RowParallelDense(h * d, embed_dim, bias=out_proj_bias,
                                         dtype=dtype, device=device)
        self.rotary = (RotaryEmbedding(rotary_emb_dim, base=rotary_emb_base)
                       if rotary_emb_dim > 0 else None)

    def forward(self, x, kv_cache=None, seqlen_offset: int = 0):
        """x: (batch, seqlen, embed_dim). Returns (out, kv_cache).

        kv_cache: (k_cache, v_cache), each (batch, hk, max_seqlen, d); the
        new keys and values are written in place at seqlen_offset.
        """
        b, sq, _ = x.shape
        h, hk, d = self.h, self.hk, self.d
        qkv = self.Wqkv(x)
        if (kv_cache is None and self.rotary is None and h == hk
                and packed_heads_supported(
                    (b, sq, h, d), (b, sq, hk, d), causal=self.causal,
                    window_size=self.window_size, softcap=self.softcap)):
            out = packed_qkv_attention(
                qkv, num_heads=h, num_heads_kv=hk, head_dim=d,
                softmax_scale=self.softmax_scale, causal=self.causal,
                softcap=self.softcap)
            return self.out_proj(out), None
        q = qkv[..., : h * d].view(b, sq, h, d)
        k = qkv[..., h * d: (h + hk) * d].view(b, sq, hk, d)
        v = qkv[..., (h + hk) * d:].view(b, sq, hk, d)
        if self.rotary is not None:
            cos, sin = self.rotary.cos_sin(sq, q.dtype, offset=seqlen_offset,
                                           device=q.device)
            q = apply_rotary_emb(q, cos, sin, self.rotary_emb_interleaved)
            k = apply_rotary_emb(k, cos, sin, self.rotary_emb_interleaved)

        if kv_cache is None:
            out = self._attend(q, k, v)
        else:
            k_cache, v_cache = kv_cache
            end = seqlen_offset + sq
            k_cache[:, :, seqlen_offset:end] = k.transpose(1, 2)
            v_cache[:, :, seqlen_offset:end] = v.transpose(1, 2)
            if seqlen_offset == 0:
                out = self._attend(q, k, v)
            else:
                out = decode_attention(
                    q, k_cache, v_cache,
                    torch.full((b,), end, dtype=torch.int32, device=x.device),
                    softmax_scale=self.softmax_scale or d ** -0.5,
                    window_size=self.window_size, softcap=self.softcap)
        return self.out_proj(out.reshape(b, sq, h * d)), kv_cache

    def _attend(self, q, k, v):
        if packed_heads_supported(q.shape, k.shape, causal=self.causal,
                                  window_size=self.window_size,
                                  softcap=self.softcap):
            return packed_heads_attention(
                q, k, v, softmax_scale=self.softmax_scale, causal=self.causal,
                softcap=self.softcap)
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            softmax_scale=self.softmax_scale, causal=self.causal,
            window_size=self.window_size, softcap=self.softcap)
        return out.transpose(1, 2)
