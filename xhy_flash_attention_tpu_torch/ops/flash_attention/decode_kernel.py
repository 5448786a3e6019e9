"""Flash-decode: few-token queries against a dense KV cache (≙
xhy_flash_attention_tpu ops/flash_attention/decode_kernel.py `flash_decode`).

On a CUDA tensor the work runs in csrc/flash_decode.cu, the counterpart of
the TPU kernel `_decode_kernel` (decode_kernel.py:47); on a CPU tensor in
its plain version :func:`flash_decode_ref`. The cache is bf16 or fp32, or a
`QuantizedKV` (int8 / e4m3 payload with per-token fp32 scales, dequantized in
the kernel's loop), read in place through its strides. Per-sample lengths,
PackGQA rows (sq * g <= 16 on CUDA), softcap, window_size[0], kv_batch_idx
and leftpad_k as in the TPU kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda
from ..quant import QUANT_DTYPES, QuantizedKV
from .common import NEG_INF, require_inference

__all__ = ["MAX_ROWS", "decode_scores_ref", "flash_decode", "flash_decode_ref",
           "launch_decode"]

MAX_ROWS = 16  # sq * (h / hk) rows per KV head that the kernel holds


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


def launch_decode(q, k_cache, v_cache, lengths, *, softmax_scale: float,
                  window_size=(-1, -1), softcap: float = 0.0,
                  kv_batch_idx=None, leftpad_k=None, out=None,
                  partials=None, split_len: int = 0) -> None:
    """Launch csrc/flash_decode.cu. Writes ``out`` (b, sq, h, d), or, with
    ``partials`` = (outs (b, hk, splits, rows, d), ms, ls (b, hk, splits,
    rows)) fp32, the per-split partials over splits of ``split_len`` keys.
    The callers count the launch."""
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
        # each lane loads d / 32 elements of a key row as one vector
        _cuda.require_aligned(t, d // 32, name)
        if t.stride(2) * S >= 2 ** 31:
            raise ValueError(f"{name}: one (batch, head) slice spans 2**31 "
                             "elements or more")
    if ks is not None and not (ks.is_contiguous() and vs.is_contiguous()
                               and ks.dtype == torch.float32):
        raise ValueError("scales must be contiguous fp32 (b, hk, S, 1)")
    if not q.is_contiguous() or (out is not None and not out.is_contiguous()):
        raise ValueError("q and out must be contiguous (b, sq, h, d)")
    outs, ms, ls = partials if partials is not None else (None, None, None)
    splits = outs.shape[2] if outs is not None else 1
    code = _cuda.lib().xfa_flash_decode(
        q.data_ptr(), kv.data_ptr(), vv.data_ptr(), _cuda.ptr(ks),
        _cuda.ptr(vs), lengths.data_ptr(), _cuda.ptr(kv_batch_idx),
        _cuda.ptr(leftpad_k), _cuda.ptr(out), _cuda.ptr(outs), _cuda.ptr(ms),
        _cuda.ptr(ls), *kv.stride()[:3], *vv.stride()[:3],
        b, sq, h, hk, S, d, _cuda.dtype_code(q), _cuda.cache_dtype_code(kv),
        splits, int(split_len), float(softmax_scale), float(softcap),
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
    q = q.contiguous()
    out = torch.empty_like(q)
    launch_decode(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale,
                  window_size=window_size, softcap=softcap,
                  kv_batch_idx=kv_batch_idx, leftpad_k=leftpad_k, out=out)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
