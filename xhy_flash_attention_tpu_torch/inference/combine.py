"""Split-KV decode and the LSE-merge combine (≙ xhy_flash_attention_tpu
inference/combine.py).

When batch * kv heads underfill the card, the cache's sequence axis is cut
into independent splits; each split yields a normalised partial output and
its running max and sum, and the partials merge with

    m = max(m_i);  l = sum l_i exp(m_i - m);  out = sum out_i l_i exp(m_i - m) / l

On a CUDA tensor the partials come from csrc/flash_decode.cu (the split
entry), the counterpart of the TPU kernel `_splitkv_kernel` (combine.py:75);
on a CPU tensor from the plain version :func:`splitkv_partials_ref`. The
merge is plain PyTorch, as the TPU package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.flash_attention.common import NEG_INF, cdiv, require_inference
from ..ops.flash_attention.decode_kernel import (
    _payload,
    _unpack_rows,
    contiguous_q,
    decode_scores_ref,
    launch_decode,
)

__all__ = ["flash_decode_splitkv", "merge_attention_partials",
           "num_splits_heuristic", "splitkv_partials_ref"]


def merge_attention_partials(outs, ms, ls, axis: int = 0):
    """Merge per-split partial attention results along ``axis``.

    outs: (..., rows, d) normalised per split (out_i = acc_i / l_i); ms/ls:
    matching (..., rows, 1) running max and sum. Returns (out, m, l) merged
    (out normalised)."""
    m = ms.amax(axis, keepdim=True)
    scale = torch.exp(ms - m) * ls
    l = scale.sum(axis, keepdim=True)
    safe_l = torch.clamp_min(l, 1e-37)
    out = (outs * (scale / safe_l)).sum(axis)
    return out, m.squeeze(axis), torch.where(l == 0.0, 0.0, l).squeeze(axis)


def num_splits_heuristic(batch: int, num_kv_heads: int, seqlen: int,
                         block_k: int, num_cores: int = 2,
                         max_splits: int = 8) -> int:
    """How many KV splits to use: enough parallel work to fill the cores,
    no more than the block count. On the card :func:`flash_decode_splitkv`
    passes its SM count (132 on an H100) as ``num_cores``; the split count
    changes the output only by rounding."""
    work = batch * num_kv_heads
    if work >= num_cores:
        return 1
    blocks = max(1, cdiv(seqlen, block_k))
    return max(1, min(max_splits, num_cores // max(work, 1), blocks))


def splitkv_partials_ref(q, k_cache, v_cache, lengths, softmax_scale,
                         num_splits: int, split_len: int,
                         window_size=(-1, -1), softcap: float = 0.0):
    """Plain version of the split kernel: per split of ``split_len`` keys,
    (outs (b, hk, splits, sq * g, d), ms, ls (b, hk, splits, sq * g)) in
    fp32. A split that sees no key reports out 0, m NEG_INF and l 0."""
    s = decode_scores_ref(q, k_cache, lengths, softmax_scale, window_size,
                          softcap)
    b, hk, rows, S = s.shape
    pad = num_splits * split_len - S
    s = F.pad(s, (0, pad), value=NEG_INF).reshape(
        b, hk, rows, num_splits, split_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp_min(m, 0.5 * NEG_INF))
    l = p.sum(-1, keepdim=True)
    p = p / torch.clamp_min(l, 1e-37)
    vv, vs = _payload(v_cache)
    if vs is not None:
        p = p * F.pad(vs, (0, pad)).reshape(b, hk, 1, num_splits, split_len)
    v = F.pad(vv.float(), (0, 0, 0, pad)).reshape(
        b, hk, num_splits, split_len, -1)
    outs = torch.einsum("bhrnt,bhntd->bhnrd", p, v)
    return (outs, m[..., 0].permute(0, 1, 3, 2).contiguous(),
            l[..., 0].permute(0, 1, 3, 2).contiguous())


def _split_plan(q, k_cache, num_splits: int, block_k: int) -> Tuple[int, int]:
    """(num_splits, keys per split) as the TPU package cuts the cache."""
    kv, ks = _payload(k_cache)
    b, hk, S = kv.shape[0], kv.shape[1], kv.shape[2]
    if ks is not None and block_k == 512:
        block_k = 1024  # the TPU package's block for 1-byte payloads
    nkv = cdiv(S, block_k)
    if num_splits <= 0:
        cores = (_cuda.sm_count(q.device.index) if q.device.type == "cuda"
                 else 2)
        num_splits = num_splits_heuristic(b, hk, S, block_k, num_cores=cores)
    num_splits = min(num_splits, nkv)
    return num_splits, cdiv(nkv, num_splits) * block_k


def flash_decode_splitkv(
    q: torch.Tensor,
    k_cache,
    v_cache,
    lengths: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    num_splits: int = 0,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    block_k: int = 512,
) -> torch.Tensor:
    """Split-KV flash decode: q (b, sq, h, d), caches (b, hk, S, d) tensors
    (any strides, head dim contiguous) or QuantizedKV; lengths (b,) int32
    including the sq new tokens. num_splits=0 picks the heuristic; 1 runs a
    single split. Returns (b, sq, h, d).

    ``flash_decode_splitkv.launches`` counts kernel launches.
    """
    kv, _ = _payload(k_cache)
    require_inference(q, kv)
    b, sq, h, d = q.shape
    hk = kv.shape[1]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    splits, split_len = _split_plan(q, k_cache, num_splits, block_k)
    if q.device.type == "cpu":
        outs, ms, ls = splitkv_partials_ref(
            q, k_cache, v_cache, lengths, softmax_scale, splits, split_len,
            window_size, softcap)
    else:
        rows = sq * (h // hk)
        outs = torch.empty(b, hk, splits, rows, d, dtype=torch.float32,
                           device=q.device)
        ms = torch.empty(b, hk, splits, rows, dtype=torch.float32,
                         device=q.device)
        ls = torch.empty_like(ms)
        launch_decode(contiguous_q(q), k_cache, v_cache, lengths,
                      softmax_scale=softmax_scale, window_size=window_size,
                      softcap=softcap, partials=(outs, ms, ls),
                      split_len=split_len)
        flash_decode_splitkv.launches += 1
    out, _, _ = merge_attention_partials(outs, ms[..., None], ls[..., None],
                                         axis=2)
    return _unpack_rows(out, b, sq, h, q.dtype)


flash_decode_splitkv.launches = 0
