"""Flash-decode: few-token queries against a dense KV cache (≙
xhy_flash_attention_tpu ops/flash_attention/decode_kernel.py `flash_decode`).

On a CUDA tensor the work runs in csrc/flash_decode.cu, the counterpart of
the TPU kernel `_decode_kernel` (decode_kernel.py:47), each (batch, kv head)
spread over a cluster of CTAs that :func:`decode_launch_plan` sizes; on a
CPU tensor in its plain version :func:`flash_decode_ref`. The cache is bf16
or fp32, or a `QuantizedKV` (int8 / e4m3 payload with per-token fp32 scales, dequantized in
the kernel's loop), read in place through its strides. Per-sample lengths,
PackGQA rows (sq * g <= 16 on CUDA), softcap, window_size[0], kv_batch_idx
and leftpad_k as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _cuda
from ..quant import QUANT_DTYPES, QuantizedKV
from .common import NEG_INF, cdiv, require_inference

__all__ = ["MAX_ROWS", "contiguous_q", "cta_chunk", "decode_launch_plan",
           "decode_scores_ref", "flash_decode", "flash_decode_ref",
           "launch_decode", "max_active_clusters"]

MAX_ROWS = 16  # sq * (h / hk) rows per KV head that the kernel holds
TILE = 64  # keys per tile of csrc/flash_decode.cu
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs per cluster (8: the portable maximum)


def _payload(cache):
    """(values, per-token scales (b, hk, S) or None) of a cache."""
    if isinstance(cache, QuantizedKV):
        return cache.values, cache.scales[..., 0]
    return cache, None


def decode_scores_ref(q, k_cache, lengths, softmax_scale, window_size=(-1, -1),
                      softcap: float = 0.0, kv_batch_idx=None, leftpad_k=None):
    """Masked fp32 scores (b, hk, sq * g, S) of the decode kernels, rows in
    PackGQA order (row = si * g + gi); invisible keys hold NEG_INF."""
    kv, ks = _payload(k_cache)
    if kv_batch_idx is not None:
        kv = kv[kv_batch_idx.long()]
        ks = ks[kv_batch_idx.long()] if ks is not None else None
    b, sq, h, d = q.shape
    hk, S = kv.shape[1], kv.shape[2]
    g = h // hk
    qr = q.float().reshape(b, sq, hk, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hk, sq * g, d)
    s = torch.einsum("bhrd,bhtd->bhrt", qr, kv.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = s * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    lp = (leftpad_k.to(torch.int64) if leftpad_k is not None
          else torch.zeros(b, dtype=torch.int64, device=q.device))
    cols = torch.arange(S, device=q.device)
    si = torch.arange(sq * g, device=q.device) // g
    pos = (lp + lengths.to(torch.int64))[:, None] - sq + si[None]  # (b, rows)
    mask = (cols[None, None] <= pos[:, :, None]) & (cols >= lp[:, None, None])
    if window_size[0] >= 0:
        mask = mask & (cols[None, None] >= pos[:, :, None] - window_size[0])
    return torch.where(mask[:, None], s, NEG_INF)


def _unpack_rows(o, b, sq, h, dtype):
    """(b, hk, sq * g, d) -> (b, sq, h, d)."""
    hk, d = o.shape[1], o.shape[-1]
    return o.reshape(b, hk, sq, h // hk, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d).to(dtype)


def flash_decode_ref(q, k_cache, v_cache, lengths, softmax_scale,
                     window_size=(-1, -1), softcap: float = 0.0,
                     kv_batch_idx=None, leftpad_k=None):
    """Plain fp32 math (≙ the TPU package's `_decode_attention_xla`).

    q: (b, sq, h, d); caches (b, hk, S, d) tensors or QuantizedKV; lengths
    (b,) including the sq new tokens. Query row r sees cache positions lp <=
    j <= lp + lengths - sq + r (lp = leftpad_k or 0).
    """
    b, sq, h, _ = q.shape
    s = decode_scores_ref(q, k_cache, lengths, softmax_scale, window_size,
                          softcap, kv_batch_idx, leftpad_k)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp_min(m, 0.5 * NEG_INF))
    l = p.sum(-1, keepdim=True)
    p = p / torch.clamp_min(l, 1e-37)
    vv, vs = _payload(v_cache)
    if kv_batch_idx is not None:
        vv = vv[kv_batch_idx.long()]
        vs = vs[kv_batch_idx.long()] if vs is not None else None
    if vs is not None:
        p = p * vs[:, :, None, :]
    out = torch.einsum("bhrt,bhtd->bhrd", p, vv.float())
    return _unpack_rows(out, b, sq, h, q.dtype)


def cta_chunk(start: int, stop: int, first: int, rank: int,
              cluster: int) -> Tuple[int, int]:
    """Keys [lo, hi) that CTA ``rank`` of a cluster of ``cluster`` CTAs reads
    of a row whose visible keys are [start, stop), in a split whose first key
    is ``first`` (0 without splits). The kernel computes the same on the
    device (csrc/flash_decode.cu):

        start_al = first + (start - first) / 64 * 64;
        n_all = stop > start_al ? cdiv(stop - start_al, 64) : 0;
        per = cdiv(n_all, csize);
        t_lo = min(n_all, rank * per);  n_tiles = min(n_all, t_lo + per) - t_lo;
        keys [start_al + t_lo * 64, start_al + (t_lo + n_tiles) * 64) ∩ [.., stop)

    Keys in [lo, start) are read as zeros and masked. An empty chunk is
    (hi, hi)."""
    start_al = first + (start - first) // TILE * TILE
    n_all = cdiv(stop - start_al, TILE) if stop > start_al else 0
    per = cdiv(n_all, cluster)
    t_lo = min(n_all, rank * per)
    t_hi = min(n_all, t_lo + per)
    hi = min(stop, start_al + t_hi * TILE)
    return min(start_al + t_lo * TILE, hi), hi


def decode_launch_plan(b: int, hk: int, S: int, splits: int, split_len: int,
                       sm_count: int) -> Tuple[int, int]:
    """(cluster, chunk_len) of a launch of csrc/flash_decode.cu: the CTAs per
    (batch, kv head, split), doubled from 1 while the grid stays within one
    CTA per SM and each CTA keeps a tile, up to 8; and the keys a CTA reads of
    a fully visible split (``split_len`` keys, or S without splits), a
    multiple of the 64-key tile. At b2 hk8 (requests A and B) that is 8, at b8
    hk8 2."""
    span = min(S, split_len) if split_len > 0 else S
    work = b * hk * splits
    tiles = cdiv(span, TILE)
    cluster = 1
    while (cluster < CLUSTER_SIZES[-1] and 2 * cluster * work <= sm_count
           and 2 * cluster <= tiles):
        cluster *= 2
    return cluster, cdiv(tiles, cluster) * TILE


def max_active_clusters(q, k_cache, cluster: int,
                        partial: bool = False) -> int:
    """How many clusters of ``cluster`` CTAs of the kernel for these q and
    cache dtypes, head dim and rows the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    kv, _ = _payload(k_cache)
    count = ctypes.c_int(0)
    code = _cuda.lib().xfa_flash_decode_max_clusters(
        _cuda.dtype_code(q), _cuda.cache_dtype_code(kv), q.shape[-1],
        int(partial), q.shape[1] * q.shape[2] // kv.shape[1], cluster,
        ctypes.byref(count))
    _cuda.check(code, "flash_decode max active clusters")
    return count.value


def contiguous_q(q: torch.Tensor) -> torch.Tensor:
    """``q`` contiguous and on a 16-byte boundary, as :func:`launch_decode`
    takes it (a copy only where needed)."""
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def launch_decode(q, k_cache, v_cache, lengths, *, softmax_scale: float,
                  window_size=(-1, -1), softcap: float = 0.0,
                  kv_batch_idx=None, leftpad_k=None, out=None,
                  partials=None, split_len: int = 0, cluster=None) -> None:
    """Launch csrc/flash_decode.cu. Writes ``out`` (b, sq, h, d), or, with
    ``partials`` = (outs (b, hk, splits, rows, d), ms, ls (b, hk, splits,
    rows)) fp32, the per-split partials over splits of ``split_len`` keys.
    ``cluster`` forces the CTAs per cluster (1, 2, 4 or 8; the tests and
    chip_smoke.py set it), else :func:`decode_launch_plan` picks it. The
    callers count the launch."""
    kv, ks = _payload(k_cache)
    vv, vs = _payload(v_cache)
    tensors = [t for t in (q, kv, vv, ks, vs, lengths, kv_batch_idx,
                           leftpad_k, out) if t is not None]
    if partials is not None:
        tensors += list(partials)
    _cuda.require_cuda(*tensors)
    b, sq, h, d = q.shape
    cb, hk, S, _ = kv.shape
    if vv.shape != kv.shape or kv.shape[3] != d or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} cache "
                         f"{tuple(kv.shape)} {tuple(vv.shape)}")
    if kv_batch_idx is None and cb != b:
        raise ValueError(f"cache batch {cb} != query batch {b}")
    quantized = kv.dtype in QUANT_DTYPES
    if vv.dtype != kv.dtype or (not quantized and kv.dtype != q.dtype) \
            or quantized != (ks is not None):
        raise TypeError(f"q {q.dtype} with caches {kv.dtype} {vv.dtype}: the "
                        "caches share q's dtype or hold a quantized payload "
                        "with scales")
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if sq * (h // hk) > MAX_ROWS:
        raise NotImplementedError(
            f"sq * h / hk = {sq * (h // hk)} rows; the kernel holds "
            f"{MAX_ROWS}")
    for t, name in ((lengths, "lengths"), (kv_batch_idx, "kv_batch_idx"),
                    (leftpad_k, "leftpad_k")):
        if t is not None and (t.shape != (b,) or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 (b,) tensor")
    for t, name in ((kv, "k_cache"), (vv, "v_cache")):
        # key rows arrive by 16-byte cp.async copies
        _cuda.require_aligned(t, 16 // t.element_size(), name)
        if t.stride(2) * S >= 2 ** 31:
            raise ValueError(f"{name}: one (batch, head) slice spans 2**31 "
                             "elements or more")
    if ks is not None and not (ks.is_contiguous() and vs.is_contiguous()
                               and ks.dtype == torch.float32):
        raise ValueError("scales must be contiguous fp32 (b, hk, S, 1)")
    if not q.is_contiguous() or q.data_ptr() % 16 or (
            out is not None and not out.is_contiguous()):
        raise ValueError("q and out must be contiguous (b, sq, h, d), q on a "
                         "16-byte boundary (its rows arrive by 16-byte copies)")
    outs, ms, ls = partials if partials is not None else (None, None, None)
    splits = outs.shape[2] if outs is not None else 1
    if cluster is None:
        cluster, _ = decode_launch_plan(b, hk, S, splits, split_len,
                                        _cuda.sm_count(q.device.index))
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster}: the kernel takes {CLUSTER_SIZES}")
    code = _cuda.lib().xfa_flash_decode(
        q.data_ptr(), kv.data_ptr(), vv.data_ptr(), _cuda.ptr(ks),
        _cuda.ptr(vs), lengths.data_ptr(), _cuda.ptr(kv_batch_idx),
        _cuda.ptr(leftpad_k), _cuda.ptr(out), _cuda.ptr(outs), _cuda.ptr(ms),
        _cuda.ptr(ls), *kv.stride()[:3], *vv.stride()[:3],
        b, sq, h, hk, S, d, _cuda.dtype_code(q), _cuda.cache_dtype_code(kv),
        splits, int(split_len), cluster, float(softmax_scale), float(softcap),
        int(window_size[0]), _cuda.stream())
    _cuda.check(code, "flash_decode")


def flash_decode(
    q: torch.Tensor,
    k_cache,
    v_cache,
    lengths: torch.Tensor,
    *,
    softmax_scale: float,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    kv_batch_idx=None,
    leftpad_k=None,
) -> torch.Tensor:
    """q: (b, sq, h, d); k/v_cache: (b, hk, S, d) tensors of any strides
    (head dim contiguous) or QuantizedKV; lengths: (b,) int32 valid lengths
    including the sq new tokens. kv_batch_idx: (b,) int32 cache batch row of
    each query row. leftpad_k: (b,) int32; the sequence occupies cache
    columns [leftpad, leftpad + length). Returns (b, sq, h, d).

    ``flash_decode.launches`` counts kernel launches.
    """
    kv, ks = _payload(k_cache)
    vv, _ = _payload(v_cache)
    if ks is None and kv.dtype in QUANT_DTYPES:
        raise TypeError("an int8 / e4m3 cache is quantized: pass it as a "
                        "QuantizedKV (values with per-token scales)")
    require_inference(q, kv, vv)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths, softmax_scale,
                                window_size, softcap, kv_batch_idx, leftpad_k)
    q = contiguous_q(q)
    out = torch.empty_like(q)
    launch_decode(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale,
                  window_size=window_size, softcap=softcap,
                  kv_batch_idx=kv_batch_idx, leftpad_k=leftpad_k, out=out)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
