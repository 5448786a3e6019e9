"""GPT model hub (≙ xhy_flash_attention_tpu models/gpt.py).

Every decoder-only family of this slice (GPT-2-style, Llama-style and
GPT-NeoX's parallel block) is this skeleton plus a config translation.
Linear and embedding weights live in ``config.dtype``; norm weights stay
fp32, as in the TPU package. Weights
are drawn from ``normal(0, initializer_range)`` with an explicit
``torch.Generator``; `state_dict_from_jax` converts the TPU package's
parameter tree instead. The forward without caches is differentiable (the
training path, training/train.py); decoding against caches runs under
``torch.inference_mode()`` (``decode`` does).

``GPTConfig.remat`` runs each block under ``torch.utils.checkpoint``
(non-reentrant) in a differentiable forward without caches, with the TPU
package's policies (its gpt.py:68-76, 228-252; ops/flash_attention/remat.py):
"save_attn" (default) keeps each block's input and its attention's (out,
lse), so the backward recomputes the rest but not the attention forward;
"save_dots" also keeps every matrix product's output; "nothing" keeps the
block's input alone. ``GPTConfig.weight_quant`` ("int8" / "int4") builds
the projections (Wqkv, out_proj, fc1, fc2 and an untied lm_head) as
``QuantDense`` for serving; :func:`quantize_gpt_params` turns a float
model's state dict into theirs, as the TPU package's does (gpt.py:380-405).
A model on CUDA runs in bfloat16 or float32 (the fp32 attention kernels of
csrc/flash_fp32.cu). The dropout fields ``embd_pdrop``, ``resid_pdrop`` and
``attn_pdrop`` are kept as the TPU package keeps them (its gpt.py:48-50);
as there, dropout applies only when a forward is called with
``deterministic=False``: ``attn_pdrop`` in every layer's attention (the
attention kernels' dropout instantiations in bf16 on the card), each
layer's seed drawn from the caller's ``dropout_generator``. Embedding and
residual dropout raise ``ValueError("dropout_p > 0 requires a seed")``
there, as the TPU package's model does: its GPTModel hands every block
``seeds=(None, None)`` (its gpt.py:269). The blocks carry those rates
(block 0's ``resid_dropout1`` is ``embd_pdrop``, as there) and run them in
the fused norm when called with seeds (modules/block.py).
GPT-2 weights load from Hugging Face (:func:`gpt2_config_to_gpt_config`,
:func:`remap_state_dict_hf_gpt2`) or a Megatron-LM checkpoint
(:func:`remap_state_dict_megatron`); utils/pretrained.py reads local files.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..modules.block import Block, _Norm
from ..modules.embedding import GPT2Embeddings
from ..modules.mha import MHA, draw_dropout_seed
from ..modules.linear import make_linear
from ..modules.mlp import GatedMlp, Mlp
from ..ops.flash_attention.common import CUDA_DTYPE_NOT_PORTED
from ..ops.flash_attention.remat import REMAT_POLICIES, checkpoint_block
from ..ops.quant import QUANT_DTYPES, QuantizedKV, pack_int4, quantize_weight
from ..utils.generation import GenerationMixin

__all__ = ["GPTConfig", "GPTLMHeadModel", "GPTModel",
           "gpt2_config_to_gpt_config", "quantize_gpt_params",
           "remap_state_dict_hf_gpt2", "remap_state_dict_megatron",
           "state_dict_from_jax"]

WEIGHT_QUANT = (None, "int8", "int4")


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
    # dropout, applied only by a forward with deterministic=False; the
    # embedding and residual rates then raise, as in the TPU package
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    residual_in_fp32: bool = True
    prenorm: bool = True
    # attention and MLP from one residual stream, their outputs summed
    # (GPT-J / NeoX); untied: the MLP reads a norm of its own
    parallel_block: bool = False
    parallel_block_tied_norm: bool = True
    lm_head_bias: bool = False
    tie_word_embeddings: bool = True
    pad_vocab_size_multiple: int = 1
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_fc1_bias: bool = True
    mlp_fc2_bias: bool = True
    initializer_range: float = 0.02
    # rematerialise each block in the backward (torch.utils.checkpoint),
    # keeping what remat_policy names: "save_attn", "save_dots", "nothing"
    remat: bool = False
    remat_policy: str = "save_attn"
    # weight-only quantized projections: None | "int8" | "int4" (serving;
    # weights through quantize_gpt_params)
    weight_quant: Optional[str] = None
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")
        if self.weight_quant not in WEIGHT_QUANT:
            raise ValueError(f"weight_quant {self.weight_quant!r}: one of "
                             f"{WEIGHT_QUANT}")

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
        dropout=c.attn_pdrop, dtype=c.dtype, device=device,
        weight_quant_dtype=c.weight_quant)


def _mlp(c: GPTConfig, device) -> nn.Module:
    inner = c.intermediate_size or 4 * c.hidden_size
    if c.activation_function in ("swiglu", "geglu"):
        return GatedMlp(
            c.hidden_size, inner,
            activation="silu" if c.activation_function == "swiglu"
            else "gelu_approx",
            bias1=c.mlp_fc1_bias, bias2=c.mlp_fc2_bias, multiple_of=1,
            dtype=c.dtype, device=device, weight_quant_dtype=c.weight_quant)
    return Mlp(c.hidden_size, inner, activation=c.activation_function,
               bias1=c.mlp_fc1_bias, bias2=c.mlp_fc2_bias, dtype=c.dtype,
               device=device, weight_quant_dtype=c.weight_quant)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device="cuda"):
        super().__init__()
        c = config
        if torch.device(device).type == "cuda" and c.dtype not in (
                torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f"a model on CUDA runs in bfloat16 or float32 (config.dtype "
                f"is {c.dtype}): {CUDA_DTYPE_NOT_PORTED}")
        self.config = c
        self.embeddings = GPT2Embeddings(
            c.hidden_size, c.padded_vocab_size, c.max_position_embeddings,
            dtype=c.dtype, device=device)
        self.layers = nn.ModuleList(
            Block(c.hidden_size, _mixer(c, device), _mlp(c, device),
                  norm_eps=c.layer_norm_epsilon, rms_norm=c.rms_norm,
                  prenorm=c.prenorm,
                  resid_dropout1=c.embd_pdrop if i == 0 else c.resid_pdrop,
                  resid_dropout2=c.resid_pdrop,
                  residual_in_fp32=c.residual_in_fp32,
                  parallel_block=c.parallel_block,
                  parallel_block_tied_norm=c.parallel_block_tied_norm,
                  device=device)
            for i in range(c.num_hidden_layers))
        self.norm_f = (_Norm(c.hidden_size, c.rms_norm, c.layer_norm_epsilon,
                             device=device) if c.prenorm else None)

    def forward(self, input_ids, position_ids=None, *, kv_caches=None,
                seqlen_offset=0, segment_ids=None, deterministic=True,
                dropout_generator: Optional[torch.Generator] = None):
        """Returns (hidden_states, kv_caches). seqlen_offset: int or (b,)
        tensor. ``deterministic`` False asks for the config's dropout (JAX
        gpt.py:180): ``attn_pdrop`` in each layer's attention, keyed on a
        seed per layer drawn from ``dropout_generator`` before the layers
        run (so that a rematerialised block redraws nothing); with
        ``embd_pdrop`` or ``resid_pdrop`` set it raises the TPU package's
        ``ValueError``. Dense caches are written in place; a layer's PagedKVCache
        comes back with advanced lengths and replaces its entry of the
        ``kv_caches`` list, which is returned. segment_ids: (b, s) ids of
        packed sequences, the queries' and the keys' of every layer's
        attention (JAX gpt.py:270). With ``config.remat``, grad enabled and
        no caches, each block runs under checkpointing with
        ``config.remat_policy`` (JAX gpt.py:228)."""
        c = self.config
        seeds = [None] * len(self.layers)
        if not deterministic:
            if max(c.embd_pdrop, c.resid_pdrop) > 0.0:
                raise ValueError("dropout_p > 0 requires a seed")
            if c.attn_pdrop > 0.0:
                seeds = [draw_dropout_seed(dropout_generator)
                         for _ in self.layers]
        hidden = self.embeddings(input_ids, position_ids,
                                 seqlen_offset=seqlen_offset)
        residual = None
        remat = (self.config.remat and kv_caches is None
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            args = (hidden, residual, cache, seqlen_offset, segment_ids,
                    segment_ids, deterministic, seeds[i])
            if remat:
                hidden, residual, cache = checkpoint_block(
                    layer, self.config.remat_policy, *args)
            else:
                hidden, residual, cache = layer(*args)
            if kv_caches is not None:
                kv_caches[i] = cache
        if self.norm_f is not None:
            hidden = self.norm_f(hidden, residual, False,
                                 self.config.residual_in_fp32)
        return hidden, kv_caches


class GPTLMHeadModel(GenerationMixin, nn.Module):
    """Decoder with an LM head. Built on ``device`` (CUDA unless the caller
    says otherwise; there ``config.dtype`` is bfloat16 or float32) with weights
    drawn from ``generator`` (a fresh one seeded with ``seed`` when None)."""

    def __init__(self, config: GPTConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.transformer = GPTModel(c, device=device)
        self.lm_head = (
            None if c.tie_word_embeddings else
            make_linear(c.hidden_size, c.padded_vocab_size, c.lm_head_bias,
                        c.weight_quant, dtype=c.dtype, device=device))
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
                seqlen_offset=0, segment_ids=None, deterministic=True,
                dropout_generator: Optional[torch.Generator] = None):
        """Returns (logits (b, s, padded_vocab), kv_caches); dropout as
        :meth:`GPTModel.forward`."""
        hidden, kv_caches = self.transformer(
            input_ids, position_ids, kv_caches=kv_caches,
            seqlen_offset=seqlen_offset, segment_ids=segment_ids,
            deterministic=deterministic, dropout_generator=dropout_generator)
        if self.lm_head is None:
            logits = nn.functional.linear(
                hidden, self.transformer.embeddings.word_embeddings.weight)
        else:
            logits = self.lm_head(hidden)
        return logits, kv_caches

    def allocate_kv_caches(self, batch_size: int, max_seqlen: int,
                           dtype=None) -> List[Tuple[Any, Any]]:
        """Per-layer (k, v) caches of shape (b, hk, max_seqlen, d): zeroed
        tensors, or for int8 / float8_e4m3fn a QuantizedKV pair (zero
        payload, unit scales (b, hk, max_seqlen, 1))."""
        c = self.config
        shape = (batch_size, c.kv_heads, max_seqlen, c.dim_head)
        dtype = dtype or c.dtype
        dev = self.device
        if dtype in QUANT_DTYPES:
            def mk():
                return QuantizedKV(
                    torch.zeros(shape, dtype=dtype, device=dev),
                    torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                               device=dev))
            return [(mk(), mk()) for _ in range(c.num_hidden_layers)]
        return [
            (torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(c.num_hidden_layers)
        ]


def state_dict_from_jax(params: Mapping, config: GPTConfig) -> Dict[str, torch.Tensor]:
    """The TPU package's GPTLMHeadModel parameters -> this port's state_dict.

    ``params`` is the flax tree as nested mappings of numpy-convertible
    arrays, with or without the top-level "params" key. Flax Dense kernels
    are (in, out) and become (out, in) Linear weights. Linear and embedding
    weights take ``config.dtype``; norm parameters stay fp32. A quantized
    tree's (kernel_q (in, out) int8 / int4, kernel_scale) become a
    QuantDense's weight_q (out, in), packed for int4, and weight_scale, its
    bias fp32 (``config.weight_quant`` says which). Returns CPU tensors for
    ``load_state_dict``.
    """
    p = params["params"] if "params" in params else params

    def arr(x, dtype=None, transpose=False):
        a = np.asarray(x, dtype=np.float32)
        t = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
        return t.to(dtype or config.dtype)

    def linear(prefix, tree):
        if "kernel_q" in tree:  # a quantized tree (quantize_gpt_params)
            q = torch.from_numpy(np.ascontiguousarray(
                np.asarray(tree["kernel_q"]).astype(np.int8).T))
            out = {f"{prefix}.weight_q": (pack_int4(q) if config.weight_quant
                                          == "int4" else q),
                   f"{prefix}.weight_scale": arr(tree["kernel_scale"],
                                                 torch.float32)}
            if "bias" in tree:
                out[f"{prefix}.bias"] = arr(tree["bias"], torch.float32)
            return out
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
    # rotary-only with tied word embeddings: the embeddings module owns no
    # parameter, and flax leaves it out of the tree
    emb = tr.get("embeddings", {})
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
        if "norm2" in layer:  # a tied parallel block has none
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


def _projection(name: str, config: GPTConfig) -> bool:
    """Whether state-dict key ``name`` is a projection weight that
    weight-only quantization replaces (the TPU package quantizes every
    kernel under mixer, mlp and lm_head)."""
    if name == "lm_head.weight":
        return not config.tie_word_embeddings
    parts = name.split(".")
    return (len(parts) == 6 and parts[0] == "transformer"
            and parts[1] == "layers" and parts[-1] == "weight"
            and parts[3] in ("mixer", "mlp"))


def quantize_gpt_params(state_dict: Mapping[str, torch.Tensor],
                        config: GPTConfig) -> Dict[str, torch.Tensor]:
    """A float model's state dict -> the state dict of a model built with
    ``config.weight_quant`` set (≙ the TPU package's gpt.py:380-405):
    every projection weight (out, in) (Wqkv, out_proj, fc1, fc2 and an
    untied lm_head) becomes weight_q (int8 (out, in), or int4 packed (out,
    in / 2) uint8) and weight_scale (out,) fp32, per output channel
    (ops.quant.quantize_weight over the input axis, the same values as the
    TPU package's on its (in, out) layout); their biases become fp32.
    Embeddings and norms stay as they are. Tensors stay on their device."""
    if config.weight_quant is None:
        raise ValueError("config.weight_quant must be set")
    dtype = torch.int8 if config.weight_quant == "int8" else "int4"
    out: Dict[str, torch.Tensor] = {}
    for name, t in state_dict.items():
        if _projection(name, config):
            prefix = name[: -len("weight")]
            q, scale = quantize_weight(t, dtype, axis=1)
            out[prefix + "weight_q"] = pack_int4(q) if dtype == "int4" else q
            out[prefix + "weight_scale"] = scale
        elif name.endswith(".bias") and _projection(name[:-4] + "weight",
                                                    config):
            out[name] = t.float()
        else:
            out[name] = t
    return out


# ---------------------------------------------------------------- GPT-2

def gpt2_config_to_gpt_config(hf_config, dtype=torch.float32) -> GPTConfig:
    """Any object with the Hugging Face GPT2Config field names (a
    ``types.SimpleNamespace`` will do) -> GPTConfig (≙ the JAX package's
    gpt.py:417-435): learned positions, LayerNorm, gelu_new
    ("gelu_approx"), tied embeddings, the three dropout rates kept."""
    g = hf_config
    n_inner = getattr(g, "n_inner", None)
    return GPTConfig(
        vocab_size=g.vocab_size,
        hidden_size=g.n_embd,
        num_hidden_layers=g.n_layer,
        num_attention_heads=g.n_head,
        intermediate_size=n_inner if n_inner is not None else 4 * g.n_embd,
        max_position_embeddings=g.n_positions,
        activation_function="gelu_approx",
        layer_norm_epsilon=g.layer_norm_epsilon,
        embd_pdrop=g.embd_pdrop,
        resid_pdrop=g.resid_pdrop,
        attn_pdrop=g.attn_pdrop,
        tie_word_embeddings=True,
        dtype=dtype,
    )


def _to_tensor(x, dtype) -> torch.Tensor:
    """A numpy array or tensor as a CPU tensor of ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu", dtype)


def _vocab_rows(w: torch.Tensor, rows: int, truncate: bool) -> torch.Tensor:
    """``w`` padded with zero rows to ``rows`` (cut to it with
    ``truncate``)."""
    if w.shape[0] < rows:
        return torch.cat([w, w.new_zeros(rows - w.shape[0], *w.shape[1:])])
    return w[:rows] if truncate else w


def remap_state_dict_hf_gpt2(state_dict: Mapping[str, Any],
                             config: GPTConfig) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``GPT2LMHeadModel`` state_dict (torch tensors or
    numpy arrays) -> this port's ``GPTLMHeadModel`` state_dict (≙ the JAX
    package's gpt.py:515-565, which builds its flax tree the same way).

    HF's Conv1D weights are (in, out), the flax layout: they are transposed
    to Linear's (out, in). The embedding is padded with zero rows to
    ``config.padded_vocab_size``. Linear and embedding weights take
    ``config.dtype``, norm weights stay fp32. Returns CPU tensors for
    ``load_state_dict``."""
    def get(name, dtype=None, transpose=False):
        t = _to_tensor(state_dict[name], dtype or config.dtype)
        return t.t().contiguous() if transpose else t

    def norm(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight", torch.float32),
                f"{dst}.bias": get(f"{src}.bias", torch.float32)}

    def linear(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight", transpose=True),
                f"{dst}.bias": get(f"{src}.bias")}

    sd = {"transformer.embeddings.word_embeddings.weight": _vocab_rows(
              get("transformer.wte.weight"), config.padded_vocab_size, False),
          "transformer.embeddings.position_embeddings.weight":
              get("transformer.wpe.weight")}
    sd.update(norm("transformer.norm_f", "transformer.ln_f"))
    for i in range(config.num_hidden_layers):
        hf, pre = f"transformer.h.{i}.", f"transformer.layers.{i}."
        sd.update(norm(pre + "norm1", hf + "ln_1"))
        sd.update(norm(pre + "norm2", hf + "ln_2"))
        sd.update(linear(pre + "mixer.Wqkv", hf + "attn.c_attn"))
        sd.update(linear(pre + "mixer.out_proj", hf + "attn.c_proj"))
        sd.update(linear(pre + "mlp.fc1", hf + "mlp.c_fc"))
        sd.update(linear(pre + "mlp.fc2", hf + "mlp.c_proj"))
    return sd


def remap_state_dict_megatron(state_dict: Mapping[str, Any],
                              config: GPTConfig) -> Dict[str, torch.Tensor]:
    """A Megatron-LM GPT checkpoint's state dict (torch tensors or numpy
    arrays, keys under ``language_model.`` or ``language_model.encoder.``)
    -> this port's ``GPTLMHeadModel`` state_dict (≙ the JAX package's
    gpt.py:438-512).

    Megatron stores Linear weights (out, in), as Linear does, with Wqkv's
    rows interleaved per head ((h, 3, d) rows): they are de-interleaved to
    [q | k | v]. The embedding is padded with zero rows to, or cut to,
    ``config.padded_vocab_size``. Linear and embedding weights take
    ``config.dtype``, norm weights stay fp32. Returns CPU tensors."""
    sd = {re.sub(r"^language_model\.(encoder\.)?", "", k): v
          for k, v in state_dict.items()}
    h, d = config.num_attention_heads, config.dim_head

    def get(name, dtype=None):
        return _to_tensor(sd[name], dtype or config.dtype)

    def deinterleave(w):
        return w.reshape(h, 3, d, *w.shape[1:]).transpose(0, 1).reshape(
            3 * h * d, *w.shape[1:]).contiguous()

    def norm(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight", torch.float32),
                f"{dst}.bias": get(f"{src}.bias", torch.float32)}

    def linear(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight"),
                f"{dst}.bias": get(f"{src}.bias")}

    out = {"transformer.embeddings.word_embeddings.weight": _vocab_rows(
               get("embedding.word_embeddings.weight"),
               config.padded_vocab_size, True),
           "transformer.embeddings.position_embeddings.weight":
               get("embedding.position_embeddings.weight")}
    out.update(norm("transformer.norm_f", "final_layernorm"))
    for i in range(config.num_hidden_layers):
        src, pre = f"layers.{i}.", f"transformer.layers.{i}."
        out.update(norm(pre + "norm1", src + "input_layernorm"))
        out.update(norm(pre + "norm2", src + "post_attention_layernorm"))
        qkv = src + "self_attention.query_key_value"
        out[pre + "mixer.Wqkv.weight"] = deinterleave(get(qkv + ".weight"))
        out[pre + "mixer.Wqkv.bias"] = deinterleave(get(qkv + ".bias"))
        out.update(linear(pre + "mixer.out_proj", src + "self_attention.dense"))
        out.update(linear(pre + "mlp.fc1", src + "mlp.dense_h_to_4h"))
        out.update(linear(pre + "mlp.fc2", src + "mlp.dense_4h_to_h"))
    return out
