"""MLP family (≙ xhy_flash_attention_tpu modules/mlp.py).

``weight_quant_dtype`` ("int8" / "int4") makes fc1 and fc2 QuantDense
projections, as the TPU package's mlp.py:44-107 does."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.activations import ACTIVATIONS, geglu, swiglu
from .linear import RowParallelDense, make_linear

__all__ = ["GatedMlp", "Mlp"]


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: str = "gelu_approx", bias1: bool = True,
                 bias2: bool = True, *, dtype=torch.float32, device="cuda",
                 weight_quant_dtype: Optional[str] = None):
        super().__init__()
        out_features = out_features or in_features
        self.activation = ACTIVATIONS[activation]
        self.fc1 = make_linear(in_features, hidden_features, bias1,
                               weight_quant_dtype, dtype=dtype, device=device)
        self.fc2 = make_linear(hidden_features, out_features, bias2,
                               weight_quant_dtype, dtype=dtype, device=device,
                               cls=RowParallelDense)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class GatedMlp(nn.Module):
    """SwiGLU / GEGLU: fc1 produces [gate; up] packed in one projection, as
    in the TPU package, and the activated gate scales up."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, activation: str = "silu",
                 bias1: bool = False, bias2: bool = False,
                 multiple_of: int = 128, *, dtype=torch.float32,
                 device="cuda", weight_quant_dtype: Optional[str] = None):
        super().__init__()
        out_features = out_features or in_features
        hidden = (hidden_features + multiple_of - 1) // multiple_of * multiple_of
        self.gate_fn = swiglu if activation == "silu" else geglu
        self.fc1 = make_linear(in_features, 2 * hidden, bias1,
                               weight_quant_dtype, dtype=dtype, device=device)
        self.fc2 = make_linear(hidden, out_features, bias2, weight_quant_dtype,
                               dtype=dtype, device=device,
                               cls=RowParallelDense)

    def forward(self, x):
        gate, up = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(self.gate_fn(gate, up))
