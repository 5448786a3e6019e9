"""Transformer block (≙ xhy_flash_attention_tpu modules/block.py).

Prenorm wiring through the fused add-norm, as in the TPU package:

    normed, residual = add_norm(x, residual, prenorm=True)
    x = mixer(normed); normed2, residual = add_norm(x, residual, ...)
    x = mlp(normed2)

and the model applies the final norm to (x, residual). Postnorm
(BERT-style): x = norm(residual + sublayer(x)).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layer_norm import dropout_add_layer_norm, dropout_add_rms_norm

__all__ = ["Block"]


class _Norm(nn.Module):
    """Parameters of one fused add-norm call (fp32, as in the TPU package)."""

    def __init__(self, hidden: int, rms: bool = False, eps: float = 1e-5, *,
                 device="cuda"):
        super().__init__()
        self.rms = rms
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden, dtype=torch.float32, device=device))
        self.bias = None if rms else nn.Parameter(
            torch.zeros(hidden, dtype=torch.float32, device=device))

    def forward(self, x0, residual, prenorm: bool, residual_in_fp32: bool):
        fn = dropout_add_rms_norm if self.rms else dropout_add_layer_norm
        return fn(x0, residual, self.weight, self.bias, 0.0, self.eps,
                  prenorm=prenorm, residual_in_fp32=residual_in_fp32)


class Block(nn.Module):
    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module, *,
                 norm_eps: float = 1e-5, rms_norm: bool = False,
                 prenorm: bool = True, residual_in_fp32: bool = False,
                 device="cuda"):
        super().__init__()
        self.prenorm = prenorm
        self.residual_in_fp32 = residual_in_fp32
        self.mixer = mixer
        self.mlp = mlp
        self.norm1 = _Norm(dim, rms_norm, norm_eps, device=device)
        self.norm2 = _Norm(dim, rms_norm, norm_eps, device=device)

    def forward(self, hidden_states, residual=None, kv_cache=None,
                seqlen_offset=0, q_segment_ids=None, kv_segment_ids=None,
                deterministic: bool = True, dropout_seed=None):
        """Returns (hidden_states, residual, kv_cache). residual is the
        running residual stream (None into the first block; None out of a
        postnorm block). The segment ids, ``deterministic`` and the
        attention dropout's ``dropout_seed`` go to the mixer."""
        segs = dict(q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids,
                    deterministic=deterministic, dropout_seed=dropout_seed)
        if not self.prenorm:
            attn_out, kv_cache = self.mixer(hidden_states, kv_cache,
                                            seqlen_offset, **segs)
            hidden_states = self.norm1(attn_out, hidden_states, False, False)
            hidden_states = self.norm2(self.mlp(hidden_states), hidden_states,
                                       False, False)
            return hidden_states, None, kv_cache
        normed, residual = self.norm1(hidden_states, residual, True,
                                      self.residual_in_fp32)
        attn_out, kv_cache = self.mixer(normed, kv_cache, seqlen_offset,
                                        **segs)
        normed2, residual = self.norm2(attn_out, residual, True,
                                       self.residual_in_fp32)
        return self.mlp(normed2), residual, kv_cache
