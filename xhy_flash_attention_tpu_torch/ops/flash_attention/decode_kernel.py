"""Flash-decode: few-token queries against a dense KV cache (≙
xhy_flash_attention_tpu ops/flash_attention/decode_kernel.py `flash_decode`).

On a CUDA tensor the work runs in csrc/flash_decode.cu, the counterpart of
the TPU kernel `_decode_kernel` (decode_kernel.py:47); on a CPU tensor in
its plain version :func:`flash_decode_ref`. This slice covers a bf16 or fp32
cache with per-sample lengths, PackGQA rows (sq * g), softcap and
window_size[0]. A quantized cache, kv_batch_idx and leftpad_k raise
NotImplementedError until the serving slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda
from .common import NEG_INF, NEXT_SLICES, require_inference

__all__ = ["MAX_ROWS", "flash_decode", "flash_decode_ref"]

MAX_ROWS = 16  # sq * (h / hk) rows per KV head that the kernel holds


def flash_decode_ref(q, k_cache, v_cache, lengths, softmax_scale,
                     window_size=(-1, -1), softcap: float = 0.0):
    """Plain fp32 math (≙ the TPU package's `_decode_attention_xla`).

    q: (b, sq, h, d); caches (b, hk, S, d); lengths (b,) including the sq new
    tokens. Query row r sees cache positions <= lengths - sq + r.
    """
    b, sq, h, d = q.shape
    hk, S = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    qf = q.float().reshape(b, sq, hk, g, d)
    s = torch.einsum("bshgd,bhtd->bhgst", qf, k_cache.float()) * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    cols = torch.arange(S, device=q.device)
    rows_abs = (lengths.to(torch.int64)[:, None] - sq
                + torch.arange(sq, device=q.device)[None])
    mask = cols[None, None, :] <= rows_abs[:, :, None]  # (b, sq, S)
    if window_size[0] >= 0:
        mask = mask & (cols[None, None, :] >= rows_abs[:, :, None]
                       - window_size[0])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp_min(m, 0.5 * NEG_INF))
    l = p.sum(-1, keepdim=True)
    p = p / torch.clamp_min(l, 1e-37)
    out = torch.einsum("bhgst,bhtd->bshgd", p, v_cache.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softmax_scale: float,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    kv_batch_idx=None,
    leftpad_k=None,
) -> torch.Tensor:
    """q: (b, sq, h, d); k/v_cache: (b, hk, S, d); lengths: (b,) int32
    valid lengths including the sq new tokens. Returns (b, sq, h, d).

    ``flash_decode.launches`` counts kernel launches.
    """
    if not isinstance(k_cache, torch.Tensor) or k_cache.dtype not in (
            torch.bfloat16, torch.float32):
        raise NotImplementedError(
            "a quantized KV cache comes with slice 2 (Paged serving) "
            f"{NEXT_SLICES}")
    if kv_batch_idx is not None or leftpad_k is not None:
        raise NotImplementedError(
            "kv_batch_idx and leftpad_k come with slice 2 (Paged serving) "
            f"{NEXT_SLICES}")
    require_inference(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths, softmax_scale,
                                window_size, softcap)
    _cuda.require_cuda(q, k_cache, v_cache, lengths)
    b, sq, h, d = q.shape
    _, hk, S, _ = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if q.dtype != k_cache.dtype or v_cache.dtype != k_cache.dtype:
        raise TypeError("q and both caches must share one dtype")
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if sq * (h // hk) > MAX_ROWS:
        raise NotImplementedError(
            f"sq * h / hk = {sq * (h // hk)} rows; the kernel holds "
            f"{MAX_ROWS}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be an int32 (b,) tensor")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous (b, hk, S, d)")
    q = q.contiguous()
    out = torch.empty_like(q)
    code = _cuda.lib().xfa_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, sq, h, hk, S, d,
        _cuda.dtype_code(k_cache), float(softmax_scale), float(softcap),
        int(window_size[0]), _cuda.stream())
    _cuda.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
