"""GPT model hub (≙ xhy_flash_attention_tpu models/gpt.py).

Every decoder-only family of this slice (GPT-2-style and Llama-style) is
this skeleton plus a config translation. Linear and embedding weights live
in ``config.dtype``; norm weights stay fp32, as in the TPU package. Weights
are drawn from ``normal(0, initializer_range)`` with an explicit
``torch.Generator``; `state_dict_from_jax` converts the TPU package's
parameter tree instead.

Inference only: call under ``torch.inference_mode()`` (``decode`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..modules.block import Block, _Norm
from ..modules.embedding import GPT2Embeddings
from ..modules.mha import MHA
from ..modules.mlp import GatedMlp, Mlp
from ..ops.flash_attention.common import CUDA_DTYPE_NOT_PORTED, NEXT_SLICES
from ..utils.generation import GenerationMixin

__all__ = ["GPTConfig", "GPTLMHeadModel", "GPTModel", "state_dict_from_jax"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_attention_heads_kv: Optional[int] = None
    head_dim: Optional[int] = None
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024  # 0 => rotary-only
    activation_function: str = "gelu_approx"  # swiglu/geglu -> GatedMlp
    rms_norm: bool = False
    layer_norm_epsilon: float = 1e-5
    rotary_emb_fraction: float = 0.0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    window_size: Tuple[int, int] = (-1, -1)
    attn_softcap: float = 0.0
    residual_in_fp32: bool = True
    prenorm: bool = True
    lm_head_bias: bool = False
    tie_word_embeddings: bool = True
    pad_vocab_size_multiple: int = 1
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_fc1_bias: bool = True
    mlp_fc2_bias: bool = True
    initializer_range: float = 0.02
    dtype: Any = torch.float32

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def kv_heads(self) -> int:
        return self.num_attention_heads_kv or self.num_attention_heads

    @property
    def dim_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def _mixer(c: GPTConfig, device) -> MHA:
    rotary_dim = int(c.dim_head * c.rotary_emb_fraction)
    return MHA(
        c.hidden_size, c.num_attention_heads, c.num_attention_heads_kv,
        c.head_dim, qkv_proj_bias=c.qkv_proj_bias,
        out_proj_bias=c.out_proj_bias, causal=True,
        window_size=c.window_size, softcap=c.attn_softcap,
        rotary_emb_dim=rotary_dim, rotary_emb_base=c.rotary_emb_base,
        rotary_emb_interleaved=c.rotary_emb_interleaved,
        dtype=c.dtype, device=device)


def _mlp(c: GPTConfig, device) -> nn.Module:
    inner = c.intermediate_size or 4 * c.hidden_size
    if c.activation_function in ("swiglu", "geglu"):
        return GatedMlp(
            c.hidden_size, inner,
            activation="silu" if c.activation_function == "swiglu"
            else "gelu_approx",
            bias1=c.mlp_fc1_bias, bias2=c.mlp_fc2_bias, multiple_of=1,
            dtype=c.dtype, device=device)
    return Mlp(c.hidden_size, inner, activation=c.activation_function,
               bias1=c.mlp_fc1_bias, bias2=c.mlp_fc2_bias, dtype=c.dtype,
               device=device)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device="cuda"):
        super().__init__()
        c = config
        if torch.device(device).type == "cuda" and c.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"a model on CUDA runs in bfloat16 (config.dtype is "
                f"{c.dtype}): {CUDA_DTYPE_NOT_PORTED}")
        self.config = c
        self.embeddings = GPT2Embeddings(
            c.hidden_size, c.padded_vocab_size, c.max_position_embeddings,
            dtype=c.dtype, device=device)
        self.layers = nn.ModuleList(
            Block(c.hidden_size, _mixer(c, device), _mlp(c, device),
                  norm_eps=c.layer_norm_epsilon, rms_norm=c.rms_norm,
                  prenorm=c.prenorm, residual_in_fp32=c.residual_in_fp32,
                  device=device)
            for _ in range(c.num_hidden_layers))
        self.norm_f = (_Norm(c.hidden_size, c.rms_norm, c.layer_norm_epsilon,
                             device=device) if c.prenorm else None)

    def forward(self, input_ids, position_ids=None, *, kv_caches=None,
                seqlen_offset: int = 0):
        """Returns (hidden_states, kv_caches)."""
        hidden = self.embeddings(input_ids, position_ids,
                                 seqlen_offset=seqlen_offset)
        residual = None
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, residual, _ = layer(hidden, residual, cache,
                                        seqlen_offset)
        if self.norm_f is not None:
            hidden = self.norm_f(hidden, residual, False,
                                 self.config.residual_in_fp32)
        return hidden, kv_caches


class GPTLMHeadModel(GenerationMixin, nn.Module):
    """Decoder with an LM head. Built on ``device`` (CUDA unless the caller
    says otherwise; there ``config.dtype`` must be bfloat16) with weights
    drawn from ``generator`` (a fresh one seeded with ``seed`` when None)."""

    def __init__(self, config: GPTConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.transformer = GPTModel(c, device=device)
        self.lm_head = (
            None if c.tie_word_embeddings else
            nn.Linear(c.hidden_size, c.padded_vocab_size, bias=c.lm_head_bias,
                      dtype=c.dtype, device=device))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.transformer.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, position_ids=None, *, kv_caches=None,
                seqlen_offset: int = 0):
        """Returns (logits (b, s, padded_vocab), kv_caches)."""
        hidden, kv_caches = self.transformer(
            input_ids, position_ids, kv_caches=kv_caches,
            seqlen_offset=seqlen_offset)
        if self.lm_head is None:
            logits = nn.functional.linear(
                hidden, self.transformer.embeddings.word_embeddings.weight)
        else:
            logits = self.lm_head(hidden)
        return logits, kv_caches

    def allocate_kv_caches(self, batch_size: int, max_seqlen: int,
                           dtype=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer zeroed (k, v) caches of shape (b, hk, max_seqlen, d)."""
        c = self.config
        shape = (batch_size, c.kv_heads, max_seqlen, c.dim_head)
        dtype = dtype or c.dtype
        if dtype not in (torch.bfloat16, torch.float32, torch.float16):
            raise NotImplementedError(
                "a quantized KV cache comes with slice 2 (Paged serving) "
                f"{NEXT_SLICES}")
        return [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(c.num_hidden_layers)
        ]


def state_dict_from_jax(params: Mapping, config: GPTConfig) -> Dict[str, torch.Tensor]:
    """The TPU package's GPTLMHeadModel parameters -> this port's state_dict.

    ``params`` is the flax tree as nested mappings of numpy-convertible
    arrays, with or without the top-level "params" key. Flax Dense kernels
    are (in, out) and become (out, in) Linear weights. Linear and embedding
    weights take ``config.dtype``; norm parameters stay fp32. Returns CPU
    tensors for ``load_state_dict``.
    """
    p = params["params"] if "params" in params else params

    def arr(x, dtype=None, transpose=False):
        a = np.asarray(x, dtype=np.float32)
        t = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
        return t.to(dtype or config.dtype)

    def linear(prefix, tree):
        out = {f"{prefix}.weight": arr(tree["kernel"], transpose=True)}
        if "bias" in tree:
            out[f"{prefix}.bias"] = arr(tree["bias"])
        return out

    def norm(prefix, tree):
        out = {f"{prefix}.weight": arr(tree["weight"], torch.float32)}
        if "bias" in tree:
            out[f"{prefix}.bias"] = arr(tree["bias"], torch.float32)
        return out

    tr = p["transformer"]
    emb = tr["embeddings"]
    sd: Dict[str, torch.Tensor] = {}
    word = (p["wte"]["embedding"] if config.tie_word_embeddings
            else emb["word_embeddings"]["embedding"])
    sd["transformer.embeddings.word_embeddings.weight"] = arr(word)
    if "position_embeddings" in emb:
        sd["transformer.embeddings.position_embeddings.weight"] = arr(
            emb["position_embeddings"]["embedding"])
    for i in range(config.num_hidden_layers):
        layer = tr[f"layers_{i}"]
        pre = f"transformer.layers.{i}"
        sd.update(norm(f"{pre}.norm1", layer["norm1"]))
        sd.update(norm(f"{pre}.norm2", layer["norm2"]))
        sd.update(linear(f"{pre}.mixer.Wqkv", layer["mixer"]["Wqkv"]))
        sd.update(linear(f"{pre}.mixer.out_proj", layer["mixer"]["out_proj"]))
        sd.update(linear(f"{pre}.mlp.fc1", layer["mlp"]["fc1"]))
        sd.update(linear(f"{pre}.mlp.fc2", layer["mlp"]["fc2"]))
    if "norm_f" in tr:
        sd.update(norm("transformer.norm_f", tr["norm_f"]))
    if not config.tie_word_embeddings:
        sd.update(linear("lm_head", p["lm_head"]))
    return sd
