"""numpy-in / numpy-out entry points for an embeddable C API (≙
xhy_flash_attention_tpu capi_bridge.py).

The reference exposes its kernels as typed extern "C" symbols
(flash_attn_fwd/bwd with ``attn_mask`` and the flashmask vectors,
flash_attn_varlen_fwd/bwd, calc_reduced_attn_scores). A C library that
embeds CPython calls these functions with plain positional arguments,
numpy arrays in and numpy arrays out, so that the C side only copies host
buffers. They run the port's entries: `flash_attention` (with the bias, the
"attn_mask") or `flashmask_attention`, `flash_attention_bwd` on the
forward's saved out and LSE, `flash_attn_varlen_func` (its autograd for the
backward) and `calc_reduced_attn_scores`, on the card, or on the CPU (the
plain versions) when the caller passes ``device="cpu"``, a keyword after
the reference's positional arguments. There is no silent fallback: without
a card and without ``device="cpu"`` the call fails.

Layouts follow the reference C API: dense tensors are (b, s, h, d),
packed varlen tensors (total, h, d) with (b + 1,) int32 cu_seqlens,
softmax_lse (b, h, sq) fp32 (varlen: (h, total_q)), the attention bias
("attn_mask") fp32 broadcastable as (bias_b, bias_h, sq, sk), and the
flashmask mask the (b, hm, sk, nv) startend_row_indices tensor (nv in {1,
2, 4}).

dtype: float32 or bfloat16, with every option of each function (float32
with an attn_mask runs the fp32 kernels' bias instantiations and, in
`attn_bwd`, the fp32 dbias kernel). ``p_dropout`` > 0 drops attention
probabilities by the keep mask keyed on ``seed``, as the JAX bridge does;
on the card in bf16 without an attn_mask (the port's other combinations
raise NotImplementedError there), and not with the flashmask mask in
`attn_fwd` (``ValueError``, as the JAX bridge). bf16 crosses the ABI as raw 2-byte
elements: a numpy ``uint16`` array (or an ``ml_dtypes.bfloat16`` one) is
read as bf16, and bf16 results come back as :func:`np_dtype` ("bfloat16")
arrays: ``ml_dtypes.bfloat16`` where that package imports, else ``uint16``
holding the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.flash_attention.common import fm_mode_for

__all__ = [
    "attn_fwd", "attn_bwd", "varlen_fwd", "varlen_bwd", "reduced_scores",
    "np_dtype",
]

try:  # numpy's bf16, where the package is there; raw 2-byte words else
    import ml_dtypes
    _BF16 = ml_dtypes.bfloat16
except ImportError:
    _BF16 = np.uint16

_DTYPES = {"float32": np.float32, "bfloat16": _BF16}


def np_dtype(name: str):
    return _DTYPES[name]


def _device(device: Optional[str]) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: uint16 or ml_dtypes'
    bfloat16 as bf16 bits, else its own dtype (or ``dtype``)."""
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # torch.from_numpy shares the memory
        a = a.copy()
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array: bf16 as :func:`np_dtype` bits."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(_BF16)
    return t.numpy()


def _to_bhsd(x, device) -> torch.Tensor:
    return _tensor(x, device).transpose(1, 2)


def _scale(softmax_scale, d: int) -> float:
    return float(softmax_scale) if softmax_scale > 0 else d ** -0.5


def _dropout(p_dropout, seed) -> dict:
    """The entries' dropout keywords, as the JAX bridge passes them."""
    return dict(dropout_p=float(p_dropout),
                dropout_seed=int(seed) if p_dropout > 0 else None)


def attn_fwd(q, k, v, bias, fm_idx, p_dropout, seed, softmax_scale,
             causal, window_left, window_right, softcap, *, device=None):
    """Dense forward (≙ flash_attn_fwd). q (b, sq, h, d), k/v (b, sk, hk,
    d) numpy (fp32 or bf16); bias fp32 (bias_b, bias_h, sq, sk) or None;
    fm_idx (b, hm, sk, nv) int32 or None. Returns (out (b, sq, h, d) in q's
    dtype, lse (b, h, sq) fp32) as numpy arrays."""
    if bias is not None and fm_idx is not None:
        raise ValueError("attn_mask and flashmask are mutually exclusive")
    if fm_idx is not None and (p_dropout > 0 or softcap > 0
                               or window_left >= 0 or window_right >= 0):
        raise ValueError(
            "flashmask composes with causal/scale only "
            "(no dropout/window/softcap), like flashmask_attention")
    from .ops.flash_attention.flashmask import flashmask_attention
    from .ops.flash_attention.interface import flash_attention

    dev = _device(device)
    qt, kt, vt = (_to_bhsd(x, dev) for x in (q, k, v))
    scale = float(softmax_scale) if softmax_scale > 0 else None
    with torch.no_grad():
        if fm_idx is not None:
            out, lse = flashmask_attention(
                qt, kt, vt, _tensor(fm_idx, dev, torch.int32),
                causal=bool(causal), softmax_scale=scale, return_lse=True)
        else:
            b = None if bias is None else _tensor(bias, dev, torch.float32)
            out, lse = flash_attention(
                qt, kt, vt, b, softmax_scale=scale, causal=bool(causal),
                window_size=(int(window_left), int(window_right)),
                softcap=float(softcap), return_lse=True,
                **_dropout(p_dropout, seed))
    return _numpy(out.transpose(1, 2)), _numpy(lse.float())


def attn_bwd(dout, q, k, v, out, lse, bias, fm_idx, p_dropout, seed,
             softmax_scale, causal, window_left, window_right, softcap, *,
             device=None):
    """Dense backward (≙ flash_attn_bwd) from the forward's saved out and
    lse (no forward recompute). Returns (dq, dk, dv, dbias): dq/dk/dv in
    the (b, s, h, d) layout and the inputs' dtype, dbias fp32 in the bias's
    broadcast shape (summed over the axes it broadcasts), or None without a
    bias."""
    if bias is not None and fm_idx is not None:
        raise ValueError("attn_mask and flashmask are mutually exclusive")
    from .ops.flash_attention.bwd import flash_attention_bwd

    dev = _device(device)
    kwargs = dict(sm_scale=_scale(softmax_scale, q.shape[-1]),
                  causal=bool(causal),
                  window_size=(int(window_left), int(window_right)),
                  softcap=float(softcap), **_dropout(p_dropout, seed))
    if fm_idx is not None:
        idx = _tensor(fm_idx, dev, torch.int32)
        kwargs.update(flashmask_vecs=idx.movedim(-1, 2).contiguous(),
                      flashmask_mode=fm_mode_for(bool(causal), idx.shape[-1]))
    with torch.no_grad():
        grads = flash_attention_bwd(
            *(_to_bhsd(x, dev) for x in (q, k, v, out)),
            _tensor(lse, dev, torch.float32), _to_bhsd(dout, dev),
            None if bias is None else _tensor(bias, dev, torch.float32),
            **kwargs)
    dq, dk, dv = (_numpy(g.transpose(1, 2)) for g in grads[:3])
    return dq, dk, dv, (None if bias is None else _numpy(grads[3].float()))


def _varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, softmax_scale, causal,
            window_left, window_right, softcap, **kw):
    from .ops.flash_attention.interface import flash_attn_varlen_func

    dev = q.device
    return flash_attn_varlen_func(
        q, k, v, _tensor(cu_seqlens_q, dev, torch.int32),
        _tensor(cu_seqlens_k, dev, torch.int32), 0, 0,
        softmax_scale=float(softmax_scale) if softmax_scale > 0 else None,
        causal=bool(causal), window_size=(int(window_left),
                                          int(window_right)),
        softcap=float(softcap), **kw)


def varlen_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, p_dropout, seed,
               softmax_scale, causal, window_left, window_right, softcap, *,
               device=None):
    """Packed varlen forward (≙ flash_attn_varlen_fwd). q (total_q, h, d),
    k/v (total_k, hk, d), cu_seqlens (b + 1,) int32. Returns (out (total_q,
    h, d), lse (h, total_q) fp32)."""
    dev = _device(device)
    with torch.no_grad():
        out, lse = _varlen(*(_tensor(x, dev) for x in (q, k, v)),
                           cu_seqlens_q, cu_seqlens_k, softmax_scale, causal,
                           window_left, window_right, softcap,
                           return_lse=True, **_dropout(p_dropout, seed))
    return _numpy(out), _numpy(lse.float())


def varlen_bwd(dout, q, k, v, cu_seqlens_q, cu_seqlens_k, p_dropout, seed,
               softmax_scale, causal, window_left, window_right, softcap, *,
               device=None):
    """Packed varlen backward (≙ flash_attn_varlen_bwd), as the gradient of
    the packed forward through its autograd function (one forward
    recompute, as the TPU package's bridge; the same seed regenerates the
    forward's keep mask). Returns (dq, dk, dv)."""
    dev = _device(device)
    ins = [_tensor(x, dev).requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = _varlen(*ins, cu_seqlens_q, cu_seqlens_k, softmax_scale,
                      causal, window_left, window_right, softcap,
                      **_dropout(p_dropout, seed))
        grads = torch.autograd.grad(out, ins, _tensor(dout, dev, out.dtype))
    return tuple(_numpy(g) for g in grads)


def reduced_scores(q, k, lse, causal, softmax_scale, *, device=None):
    """≙ calc_reduced_attn_scores: per-key attention mass summed over the
    queries. q (b, sq, h, d), k (b, sk, hk, d); lse (b, h, sq) fp32 from a
    prior forward, or None to compute it here (the forward with k as the
    values, as the TPU package's bridge). Returns (b, h, sk) fp32."""
    from .ops.flash_attention.fwd import flash_attention_fwd
    from .ops.flash_attention.reduced_scores import calc_reduced_attn_scores

    dev = _device(device)
    qt, kt = _to_bhsd(q, dev), _to_bhsd(k, dev)
    scale = _scale(softmax_scale, q.shape[-1])
    with torch.no_grad():
        if lse is None:
            _, lse_t = flash_attention_fwd(qt, kt, kt, sm_scale=scale,
                                           causal=bool(causal))
        else:
            lse_t = _tensor(lse, dev, torch.float32)
        red = calc_reduced_attn_scores(qt, kt, lse_t, causal=bool(causal),
                                       softmax_scale=scale)
    return _numpy(red.float())
