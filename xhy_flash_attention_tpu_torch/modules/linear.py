"""Linear layers (≙ xhy_flash_attention_tpu modules/linear.py).

`RowParallelDense` is a plain `nn.Linear` here: tensor parallelism comes
with a later slice. The weight is stored (out, in), PyTorch's layout;
`models.gpt.state_dict_from_jax` transposes the TPU package's (in, out)
kernels.

`QuantDense` (≙ `QuantDense` and `_quant_kernel_params`, the TPU
package's linear.py:47-87) holds weight-only quantized projections for
serving: int8 weights (out, in), or int4 packed two a byte along the input
axis (out, in / 2) uint8, per-output-channel fp32 scales and an optional
fp32 bias, all buffers (no gradient). Its forward is
`ops.quant.quant_linear`: the weight dequantized to the input's dtype,
then ``F.linear``, the scale and the bias in fp32. The buffers start as
zero weights and unit scales; weights arrive through
`models.gpt.quantize_gpt_params` or `state_dict_from_jax`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.quant import quant_linear

__all__ = ["QuantDense", "RowParallelDense", "make_linear"]


class RowParallelDense(nn.Linear):
    """The output projection of attention and MLP blocks."""


class QuantDense(nn.Module):
    """y = x dequant(W)^T * scale (+ bias) with int8 or int4 W."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant_dtype: str = "int8", *, device="cuda"):
        super().__init__()
        if quant_dtype not in ("int8", "int4"):
            raise ValueError(f"quant_dtype {quant_dtype!r}: 'int8' or 'int4'")
        if quant_dtype == "int4" and in_features % 2:
            raise ValueError(f"int4 packs two inputs a byte: in_features "
                             f"{in_features} must be even")
        self.in_features, self.out_features = in_features, out_features
        self.quant_dtype = quant_dtype
        cols, dt = ((in_features // 2, torch.uint8) if quant_dtype == "int4"
                    else (in_features, torch.int8))
        self.register_buffer("weight_q", torch.zeros(
            out_features, cols, dtype=dt, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=torch.float32, device=device)
            if bias else None)

    def forward(self, x):
        return quant_linear(x, self.weight_q, self.weight_scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, quant_dtype={self.quant_dtype}, "
                f"bias={self.bias is not None}")


def make_linear(in_features: int, out_features: int, bias: bool,
                quant_dtype: Optional[str], *, dtype, device,
                cls=nn.Linear) -> nn.Module:
    """``cls`` (a float linear in ``dtype``), or a QuantDense when
    ``quant_dtype`` is "int8" or "int4"."""
    if quant_dtype is not None:
        return QuantDense(in_features, out_features, bias, quant_dtype,
                          device=device)
    return cls(in_features, out_features, bias=bias, dtype=dtype,
               device=device)
