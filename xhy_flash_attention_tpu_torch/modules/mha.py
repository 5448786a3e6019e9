"""Multi-head attention with a KV cache (≙ xhy_flash_attention_tpu
modules/mha.py `MHA`).

Routing follows the TPU package (mha.py:168-377):
  * no cache, no rotary, no segment ids, h == hk: attention straight on the
    packed Wqkv output (packed_qkv_attention) when the packed gate allows
    (no window);
  * a PagedKVCache (continuous batching: decode, chunked prefill,
    speculative verify): append_paged_kv, then paged_flash_decode;
  * a dense cache, bf16 / fp32 tensors or QuantizedKV (int8 / e4m3 with
    per-token scales): the new keys and values are written at
    seqlen_offset; prefill (seqlen_offset == 0) runs `_attend`, which takes
    the packed-heads kernel when supported (no segment ids, no window),
    else flash_attention; decode
    runs decode_attention against the cache at lengths offset + sq;
  * no cache: `_attend`.
seqlen_offset is an int, or a (b,) tensor of per-sample offsets (rotary
then rotates each sample at its own positions). A tensor offset is read on
the device only (rotary, the cache write, the decode lengths), so a step
captured in a CUDA graph replays the offset the tensor holds at each replay;
an int would be baked into the graph.

``weight_quant_dtype`` ("int8" / "int4") makes Wqkv and out_proj
QuantDense projections (the TPU package's mha.py:99-127).

``dropout`` is the attention dropout rate, applied by a forward with
``deterministic=False`` (the TPU package's mha.py:186-195, 261-265) in the
attention of a call without a cache or of a prefill: with the
``dropout_seed`` given, or else a seed drawn from the caller's
``dropout_generator`` (a ``torch.Generator``, the counterpart of the TPU
package's "dropout" rng stream), uniform in [0, 2^31 - 1) as there.

The TPU package returns new caches; here dense caches and pages are written
in place and the same tensors are returned. A paged cache comes back as a
new PagedKVCache over the same pages, with advanced lengths
(inference/paged.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..inference.paged import PagedKVCache, append_paged_kv, paged_flash_decode
from ..layers.rotary import RotaryEmbedding, apply_rotary_emb
from ..ops.decode import decode_attention, write_kv
from ..ops.flash_attention.fused_heads import (
    packed_heads_attention,
    packed_heads_supported,
    packed_qkv_attention,
)
from ..ops.flash_attention.interface import flash_attention
from .linear import RowParallelDense, make_linear

__all__ = ["MHA", "draw_dropout_seed"]


def draw_dropout_seed(generator: Optional[torch.Generator]) -> int:
    """An attention dropout seed uniform in [0, 2^31 - 1) from the caller's
    ``generator`` (the TPU package's randint on its "dropout" rng stream,
    mha.py:188-190), read on the host; ``ValueError`` without one."""
    if generator is None:
        raise ValueError("dropout_p > 0 requires a seed: pass dropout_seed "
                         "or dropout_generator")
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


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
        dropout: float = 0.0,
        *,
        dtype=torch.float32,
        device="cuda",
        weight_quant_dtype: Optional[str] = None,
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
        self.dropout = dropout
        self.rotary_emb_dim = rotary_emb_dim
        self.rotary_emb_interleaved = rotary_emb_interleaved
        self.Wqkv = make_linear(embed_dim, (h + 2 * hk) * d, qkv_proj_bias,
                                weight_quant_dtype, dtype=dtype, device=device)
        self.out_proj = make_linear(h * d, embed_dim, out_proj_bias,
                                    weight_quant_dtype, dtype=dtype,
                                    device=device, cls=RowParallelDense)
        self.rotary = (RotaryEmbedding(rotary_emb_dim, base=rotary_emb_base)
                       if rotary_emb_dim > 0 else None)

    def forward(self, x, kv_cache=None, seqlen_offset=0, *,
                q_segment_ids=None, kv_segment_ids=None,
                deterministic: bool = True, dropout_seed=None,
                dropout_generator: Optional[torch.Generator] = None):
        """x: (batch, seqlen, embed_dim). Returns (out, kv_cache).

        kv_cache: (k_cache, v_cache), each a (batch, hk, max_seqlen, d)
        tensor or QuantizedKV, whose new keys and values are written in
        place at seqlen_offset; or a PagedKVCache. seqlen_offset: int or
        (batch,) tensor. q_segment_ids / kv_segment_ids: (batch, seqlen)
        ids for packed sequences (only equal ids attend), read by the
        attention of a prefill or a call without a cache.
        ``deterministic`` False applies ``self.dropout`` there, keyed on
        ``dropout_seed`` or on a seed drawn from ``dropout_generator``
        (one of them is needed; ``ValueError`` else).
        """
        b, sq, _ = x.shape
        h, hk, d = self.h, self.hk, self.d
        drop = self._dropout(deterministic, dropout_seed, dropout_generator)
        qkv = self.Wqkv(x)
        segs = (q_segment_ids, kv_segment_ids)
        if (kv_cache is None and self.rotary is None and h == hk
                and q_segment_ids is None and kv_segment_ids is None
                and packed_heads_supported(
                    (b, sq, h, d), (b, sq, hk, d), causal=self.causal,
                    window_size=self.window_size, softcap=self.softcap)):
            out = packed_qkv_attention(
                qkv, num_heads=h, num_heads_kv=hk, head_dim=d,
                softmax_scale=self.softmax_scale, causal=self.causal,
                softcap=self.softcap, **drop)
            return self.out_proj(out), None
        q = qkv[..., : h * d].view(b, sq, h, d)
        k = qkv[..., h * d: (h + hk) * d].view(b, sq, hk, d)
        v = qkv[..., (h + hk) * d:].view(b, sq, hk, d)
        if self.rotary is not None:
            cos, sin = self.rotary.cos_sin(sq, q.dtype, offset=seqlen_offset,
                                           device=q.device)
            q = apply_rotary_emb(q, cos, sin, self.rotary_emb_interleaved)
            k = apply_rotary_emb(k, cos, sin, self.rotary_emb_interleaved)

        scale = self.softmax_scale or d ** -0.5
        if isinstance(kv_cache, PagedKVCache):
            kv_cache = append_paged_kv(kv_cache, k.transpose(1, 2),
                                       v.transpose(1, 2))
            out = paged_flash_decode(q, kv_cache, softmax_scale=scale,
                                     window_size=self.window_size,
                                     softcap=self.softcap)
        elif kv_cache is None:
            out = self._attend(q, k, v, *segs, **drop)
        else:
            k_cache, v_cache = kv_cache
            write_kv(k_cache, k, seqlen_offset)
            write_kv(v_cache, v, seqlen_offset)
            if isinstance(seqlen_offset, int) and seqlen_offset == 0:
                out = self._attend(q, k, v, *segs, **drop)
            else:
                if isinstance(seqlen_offset, torch.Tensor):
                    lengths = (seqlen_offset.to(torch.int32) + sq).expand(
                        b).contiguous()
                else:
                    lengths = torch.full((b,), seqlen_offset + sq,
                                         dtype=torch.int32, device=x.device)
                out = decode_attention(
                    q, k_cache, v_cache, lengths, softmax_scale=scale,
                    window_size=self.window_size, softcap=self.softcap)
        return self.out_proj(out.reshape(b, sq, h * d)), kv_cache

    def _dropout(self, deterministic: bool, seed, generator) -> dict:
        """The attention's dropout keywords: none when deterministic or
        the rate is 0; else the rate and ``seed``, or one drawn from
        ``generator`` (the TPU package's randint(0, 2^31 - 1))."""
        if deterministic or self.dropout <= 0.0:
            return {}
        if seed is None:
            seed = draw_dropout_seed(generator)
        return dict(dropout_p=self.dropout, dropout_seed=seed)

    def _attend(self, q, k, v, q_seg=None, kv_seg=None, **drop):
        if (q_seg is None and kv_seg is None
                and packed_heads_supported(
                    q.shape, k.shape, causal=self.causal,
                    window_size=self.window_size, softcap=self.softcap)):
            return packed_heads_attention(
                q, k, v, softmax_scale=self.softmax_scale, causal=self.causal,
                softcap=self.softcap, **drop)
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None,
            q_seg, kv_seg, softmax_scale=self.softmax_scale,
            causal=self.causal, window_size=self.window_size,
            softcap=self.softcap, **drop)
        return out.transpose(1, 2)
