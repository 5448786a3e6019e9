"""INT8 / FP8 KV-cache quantization (≙ xhy_flash_attention_tpu ops/quant.py).

Per-token, per-head, symmetric: one fp32 scale per (b, head, position), the
largest |value| of the row over qmax. The arithmetic is the TPU package's, op
for op in fp32 (`torch.round` rounds half to even, as `jnp.round` does), so
the payload and the scales agree bit for bit with the JAX package.

The weight-only quantization (`quantize_weight`, `weight_only_quant_matmul`)
and `quantize_fp8_per_head` come with the model's weight-quant and fp8-prefill
paths (slice 7).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantizedKV", "dequantize_kv", "quantize_kv", "bits"]

_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
QUANT_DTYPES = tuple(_QMAX)


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
