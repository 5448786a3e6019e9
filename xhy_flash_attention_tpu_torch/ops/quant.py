"""Quantization (≙ xhy_flash_attention_tpu ops/quant.py): INT8 / FP8 KV
caches, FP8 prefill inputs and weight-only INT8 / INT4 projections.

KV caches: per-token, per-head, symmetric: one fp32 scale per (b, head,
position), the largest |value| of the row over qmax. FP8 prefill
(:func:`quantize_fp8_per_head`): one e4m3 scale per (batch, KV-head group),
the descale that `flash_attn_fp8_func` takes. Weights
(:func:`quantize_weight`): per output channel, int8 or int4. The arithmetic
is the TPU package's, op for op in fp32 (`torch.round` rounds half to even,
as `jnp.round` does; the e4m3 cast rounds to nearest even, as ml_dtypes
does), so payloads and scales agree bit for bit with the JAX package.

PyTorch has no int4 tensor: int4 values travel as int8 in [-7, 7]
(``quantize_weight(w, "int4")``), and :func:`pack_int4` stores two of them
a byte along the input axis, so that a quantized model holds half of int8's
bytes. :func:`weight_only_quant_matmul` has no kernel in the TPU package
(XLA fuses the convert into the dot); here it dequantizes to the input's
dtype and calls ``F.linear``, then scales the result in fp32. In fp32 that
is the TPU package's arithmetic; in bf16 the product is rounded to bf16
before the scale (cuBLAS has no fp32 output for bf16 inputs), one bf16
unit at most from the TPU package's single rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["QuantizedKV", "bits", "dequantize_kv", "dequantize_weight",
           "pack_int4", "quant_linear", "quantize_fp8_per_head",
           "quantize_kv", "quantize_weight", "unpack_int4",
           "weight_only_quant_matmul"]

_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
QUANT_DTYPES = tuple(_QMAX)
# weight-only quantization: "int4" names the int4 values carried as int8
WEIGHT_QMAX = {torch.int8: 127.0, "int4": 7.0}


@dataclasses.dataclass
class QuantizedKV:
    """Quantized cache tensor: values (b, hk, S, d) int8/fp8 and per-token
    scales (b, hk, S, 1) fp32."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def clone(self) -> "QuantizedKV":
        return QuantizedKV(self.values.clone(), self.scales.clone())


def bits(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor viewed as its bytes (uint8), anything else as it is:
    indexing, stacking and scattering move e4m3 payloads as bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_kv(x: torch.Tensor, dtype=torch.int8) -> QuantizedKV:
    """x: (..., d) -> per-row symmetric quantization."""
    if dtype not in _QMAX:
        raise TypeError(f"quantize_kv takes int8 or float8_e4m3fn, got {dtype}")
    qmax = _QMAX[dtype]
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    # divide by a tensor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which rounds differently
    scale = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-8)
    q = xf / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return QuantizedKV(values=q.to(dtype), scales=scale)


def dequantize_kv(qkv: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    return (qkv.values.float() * qkv.scales).to(dtype)


def _div(x: torch.Tensor, qmax: float, floor: float) -> torch.Tensor:
    """max(x / qmax, floor), dividing by a tensor (quantize_kv's note)."""
    return torch.clamp_min(x / torch.full_like(x, qmax), floor)


def quantize_fp8_per_head(x: torch.Tensor, num_kv_heads: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, kv-head) symmetric FP8 e4m3 quantization for the fp8
    prefill (≙ the TPU package's quant.py:79-99, FA3's q/k/v_descale).

    x: (b, s, h, d). ``num_kv_heads`` groups the query heads GQA-style
    (each group of h // num_kv_heads heads shares one scale); default per
    head. Returns (values float8_e4m3fn (b, s, h, d), descale fp32 (b,
    num_kv_heads)), dequant(x) = values * descale[b, head group]."""
    b, s, h, d = x.shape
    hk = num_kv_heads or h
    if h % hk:
        raise ValueError(f"{h} heads do not group over {hk}")
    xf = x.float().reshape(b, s, hk, (h // hk) * d)
    amax = xf.abs().amax(dim=(1, 3))  # (b, hk)
    scale = _div(amax, 448.0, 1e-8)
    q = (xf / scale[:, None, :, None]).reshape(b, s, h, d)
    return q.to(torch.float8_e4m3fn), scale


def quantize_weight(w: torch.Tensor, dtype=torch.int8,
                    axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-only per-output-channel quantization on the TPU package's
    layout (its quant.py:102-111): w (in, out) -> (w_q (in, out) int8,
    scale (out,) fp32); ``axis`` is the reduction (input) axis. ``dtype``
    torch.int8 or "int4" (values in [-7, 7], carried as int8)."""
    if dtype not in WEIGHT_QMAX:
        raise TypeError(f"quantize_weight takes torch.int8 or 'int4', got "
                        f"{dtype!r}")
    qmax = WEIGHT_QMAX[dtype]
    wf = w.float()
    scale = _div(wf.abs().amax(dim=axis, keepdim=True), qmax, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return q.to(torch.int8), scale.reshape(-1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (..., n) as int8 in [-8, 7], n even -> (..., n / 2)
    uint8: value 2j in the low nibble of byte j, 2j + 1 in the high."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even length, got "
                         f"{q.shape[-1]}")
    nib = (q.to(torch.int16) & 0xF).view(*q.shape[:-1], -1, 2)
    return (nib[..., 0] | (nib[..., 1] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: (..., n / 2) uint8 -> (..., n)
    signed values in ``dtype``. On the bytes as int8: the low nibble
    shifted up and back down (arithmetic, sign-extending), the high one
    shifted down."""
    s = p.view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(s, 4), 4)
    hi = torch.bitwise_right_shift(s, 4)
    return torch.stack((lo, hi), dim=-1).flatten(-2).to(dtype)


def dequantize_weight(weight_q: torch.Tensor, dtype) -> torch.Tensor:
    """An (out, in) int8 or (out, in / 2) packed-int4 (uint8) weight as
    ``dtype`` values (exact: |values| <= 127)."""
    if weight_q.dtype == torch.uint8:
        return unpack_int4(weight_q, dtype)
    return weight_q.to(dtype)


def quant_linear(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(W)^T * scale (+ bias) on PyTorch's (out, in) layout:
    ``weight_q`` int8 (out, in) or packed int4 uint8 (out, in / 2), scale
    and bias (out,) fp32. The product in x's dtype, then the scale and the
    bias in fp32, cast back to x's dtype (the module docstring)."""
    y = F.linear(x, dequantize_weight(weight_q, x.dtype)).float() * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def weight_only_quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """y = x @ dequant(w_q) (+ bias) on the TPU package's layout (its
    quant.py:114-127): x (..., in), w_q (in, out) int8 (int4 values as
    int8), scale (out,)."""
    return quant_linear(x, w_q.t(), scale, bias)
