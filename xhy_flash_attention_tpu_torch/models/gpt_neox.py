"""GPT-NeoX / Pythia on the GPT skeleton (≙ xhy_flash_attention_tpu
models/gpt_neox.py): the parallel residual with untied norms
(``use_parallel_residual``), partial non-interleaved rotary
(``rotary_pct``), LayerNorm, biases everywhere, and Hugging Face's
per-head interleaved Wqkv layout ((h, 3, d) rows) remapped to the
skeleton's [q | k | v]."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from .gpt import GPTConfig, _to_tensor, _vocab_rows

__all__ = ["gpt_neox_config_to_gpt_config", "remap_state_dict_hf_gpt_neox"]


def _rotary(c) -> Tuple[float, float]:
    """(rotary fraction, base): ``rotary_pct`` and ``rotary_emb_base`` (the
    JAX package reads these, as transformers 4 names them), else
    transformers 5's ``rope_parameters`` ``partial_rotary_factor`` and
    ``rope_theta``."""
    rope = getattr(c, "rope_parameters", None)
    rope = rope if isinstance(rope, Mapping) else {}
    frac = getattr(c, "rotary_pct", None)
    if frac is None:
        frac = rope.get("partial_rotary_factor",
                        getattr(c, "partial_rotary_factor", None))
    if frac is None:
        raise ValueError("the config gives no rotary fraction (rotary_pct "
                         "or partial_rotary_factor)")
    base = getattr(c, "rotary_emb_base", None)
    if base is None:
        base = rope.get("rope_theta", getattr(c, "rope_theta", 10000.0))
    return float(frac), float(base)


def gpt_neox_config_to_gpt_config(hf_config, dtype=torch.float32) -> GPTConfig:
    """Any object with the Hugging Face GPTNeoXConfig field names (a
    ``types.SimpleNamespace`` will do) -> GPTConfig (≙ the JAX package's
    gpt_neox.py:24-45): rotary only, ``rotary_pct`` of each head, parallel
    block from ``use_parallel_residual`` with untied norms, "gelu_new" as
    "gelu_approx"."""
    c = hf_config
    act = {"gelu_new": "gelu_approx"}.get(c.hidden_act, c.hidden_act)
    rotary_fraction, rotary_base = _rotary(c)
    return GPTConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=0,  # rotary-only
        activation_function=act,
        layer_norm_epsilon=c.layer_norm_eps,
        initializer_range=c.initializer_range,
        rotary_emb_fraction=rotary_fraction,
        rotary_emb_base=rotary_base,
        rotary_emb_interleaved=False,
        prenorm=True,
        parallel_block=c.use_parallel_residual,
        parallel_block_tied_norm=False,
        tie_word_embeddings=c.tie_word_embeddings,
        dtype=dtype,
    )


def _deinterleave_qkv(w: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """(h * 3 * d, ...) rows in (head, q/k/v, d) order -> (3 * h * d, ...)
    in (q/k/v, head, d) order (the JAX package's `_deinterleave_qkv`)."""
    rest = w.shape[1:]
    return w.reshape(h, 3, d, *rest).transpose(0, 1).reshape(
        3 * h * d, *rest).contiguous()


def remap_state_dict_hf_gpt_neox(state_dict: Mapping[str, Any],
                                 config: GPTConfig) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``GPTNeoXForCausalLM`` state_dict (torch tensors or
    numpy arrays) -> this port's ``GPTLMHeadModel`` state_dict (≙ the JAX
    package's gpt_neox.py:55-119, which builds its flax tree the same way).

    Both sides store Linear weights (out, in): nothing is transposed, and
    Wqkv's rows and bias are de-interleaved per head. The embedding and an
    untied head (``embed_out``) are padded with zero rows to
    ``config.padded_vocab_size``. Linear and embedding weights take
    ``config.dtype``, norm weights stay fp32. Returns CPU tensors for
    ``load_state_dict``."""
    h = config.num_attention_heads
    d = config.hidden_size // h
    rows = config.padded_vocab_size

    def get(name, dtype=None):
        return _to_tensor(state_dict[name], dtype or config.dtype)

    def norm(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight", torch.float32),
                f"{dst}.bias": get(f"{src}.bias", torch.float32)}

    def linear(dst, src):
        return {f"{dst}.weight": get(f"{src}.weight"),
                f"{dst}.bias": get(f"{src}.bias")}

    sd = {"transformer.embeddings.word_embeddings.weight": _vocab_rows(
        get("gpt_neox.embed_in.weight"), rows, False)}
    sd.update(norm("transformer.norm_f", "gpt_neox.final_layer_norm"))
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _vocab_rows(get("embed_out.weight"), rows,
                                           False)
    for i in range(config.num_hidden_layers):
        src, pre = f"gpt_neox.layers.{i}.", f"transformer.layers.{i}."
        sd.update(norm(pre + "norm1", src + "input_layernorm"))
        sd.update(norm(pre + "norm2", src + "post_attention_layernorm"))
        qkv = src + "attention.query_key_value"
        sd[pre + "mixer.Wqkv.weight"] = _deinterleave_qkv(
            get(qkv + ".weight"), h, d)
        sd[pre + "mixer.Wqkv.bias"] = _deinterleave_qkv(
            get(qkv + ".bias"), h, d)
        sd.update(linear(pre + "mixer.out_proj", src + "attention.dense"))
        sd.update(linear(pre + "mlp.fc1", src + "mlp.dense_h_to_4h"))
        sd.update(linear(pre + "mlp.fc2", src + "mlp.dense_4h_to_h"))
    return sd
