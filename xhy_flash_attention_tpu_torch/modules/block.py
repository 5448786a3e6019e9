"""Transformer block (≙ xhy_flash_attention_tpu modules/block.py).

Prenorm wiring through the fused dropout-add-norm, as in the TPU package:

    normed, residual = dropout_add_norm(x, residual, prenorm=True)
    x = mixer(normed); normed2, residual = dropout_add_norm(x, residual, ...)
    x = mlp(normed2)

and the model applies the final norm to (x, residual). Postnorm
(BERT-style): x = norm(residual + dropout(sublayer(x))). The parallel block
(GPT-J / NeoX / Falcon style) feeds attention and MLP from one norm and
sums their outputs; with untied norms the MLP reads norm2 of the same
residual stream. Residual dropout (``resid_dropout1`` / ``resid_dropout2``)
runs in the fused norm when the block is called with
``deterministic=False``, keyed on ``seeds`` (one per norm call; a rate above
0 with its seed None raises, as in the TPU package).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layer_norm import dropout_add_layer_norm, dropout_add_rms_norm

__all__ = ["Block"]


class _Norm(nn.Module):
    """Parameters of one fused dropout-add-norm call (fp32, as in the TPU
    package)."""

    def __init__(self, hidden: int, rms: bool = False, eps: float = 1e-5, *,
                 device="cuda"):
        super().__init__()
        self.rms = rms
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden, dtype=torch.float32, device=device))
        self.bias = None if rms else nn.Parameter(
            torch.zeros(hidden, dtype=torch.float32, device=device))

    def forward(self, x0, residual, prenorm: bool, residual_in_fp32: bool,
                dropout_p: float = 0.0, seed=None, rowscale=None):
        fn = dropout_add_rms_norm if self.rms else dropout_add_layer_norm
        return fn(x0, residual, self.weight, self.bias, dropout_p, self.eps,
                  rowscale=rowscale, prenorm=prenorm,
                  residual_in_fp32=residual_in_fp32, seed=seed)


class Block(nn.Module):
    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module, *,
                 norm_eps: float = 1e-5, rms_norm: bool = False,
                 prenorm: bool = True, resid_dropout1: float = 0.0,
                 resid_dropout2: float = 0.0, residual_in_fp32: bool = False,
                 parallel_block: bool = False,
                 parallel_block_tied_norm: bool = True, device="cuda"):
        super().__init__()
        self.prenorm = prenorm
        self.resid_dropout1 = resid_dropout1
        self.resid_dropout2 = resid_dropout2
        self.residual_in_fp32 = residual_in_fp32
        self.parallel_block = parallel_block
        self.mixer = mixer
        self.mlp = mlp
        self.norm1 = _Norm(dim, rms_norm, norm_eps, device=device)
        # a tied parallel block has one norm, as the TPU package's
        untied = not (prenorm and parallel_block and parallel_block_tied_norm)
        self.norm2 = (_Norm(dim, rms_norm, norm_eps, device=device)
                      if untied else None)

    def forward(self, hidden_states, residual=None, kv_cache=None,
                seqlen_offset=0, q_segment_ids=None, kv_segment_ids=None,
                deterministic: bool = True, dropout_seed=None,
                seeds=(None, None)):
        """Returns (hidden_states, residual, kv_cache). residual is the
        running residual stream (None into the first block; None out of a
        postnorm block). The segment ids, ``deterministic`` and the
        attention dropout's ``dropout_seed`` go to the mixer; ``seeds`` key
        the residual dropout of norm1 and norm2 (used when
        ``deterministic`` is False and the rate is above 0)."""
        p1 = 0.0 if deterministic else self.resid_dropout1
        p2 = 0.0 if deterministic else self.resid_dropout2
        segs = dict(q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids,
                    deterministic=deterministic, dropout_seed=dropout_seed)
        if not self.prenorm:
            attn_out, kv_cache = self.mixer(hidden_states, kv_cache,
                                            seqlen_offset, **segs)
            hidden_states = self.norm1(attn_out, hidden_states, False, False,
                                       p1, seeds[0])
            hidden_states = self.norm2(self.mlp(hidden_states), hidden_states,
                                       False, False, p2, seeds[1])
            return hidden_states, None, kv_cache
        normed, residual = self.norm1(hidden_states, residual, True,
                                      self.residual_in_fp32, p1, seeds[0])
        attn_out, kv_cache = self.mixer(normed, kv_cache, seqlen_offset,
                                        **segs)
        if self.parallel_block:
            if self.norm2 is None:
                normed_mlp = normed
            else:
                # norm2 re-normalizes the same post-dropout-add residual
                normed_mlp = self.norm2(residual.to(normed.dtype), None,
                                        False, False)
            return attn_out + self.mlp(normed_mlp), residual, kv_cache
        normed2, residual = self.norm2(attn_out, residual, True,
                                       self.residual_in_fp32, p2, seeds[1])
        return self.mlp(normed2), residual, kv_cache
