"""Llama / Llama-2 / Llama-3 on the GPT skeleton (≙ xhy_flash_attention_tpu
models/llama.py): RMSNorm, SwiGLU MLP, full-head non-interleaved rotary,
GQA, no biases, untied head by default."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from .gpt import GPTConfig

__all__ = ["llama_config_to_gpt_config", "remap_state_dict_hf_llama"]


def llama_config_to_gpt_config(hf_config, dtype=torch.float32) -> GPTConfig:
    """Any object with the Hugging Face LlamaConfig field names (a
    ``types.SimpleNamespace`` will do) -> GPTConfig."""
    c = hf_config
    window = (-1, -1)
    sw = getattr(c, "sliding_window", None)
    if sw:
        window = (sw - 1, 0)
    return GPTConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_attention_heads_kv=getattr(c, "num_key_value_heads", None),
        head_dim=getattr(c, "head_dim", None),
        intermediate_size=c.intermediate_size,
        max_position_embeddings=0,  # rotary-only
        activation_function="swiglu",
        rms_norm=True,
        layer_norm_epsilon=c.rms_norm_eps,
        rotary_emb_fraction=1.0,
        rotary_emb_base=getattr(c, "rope_theta", 10000.0),
        rotary_emb_interleaved=False,
        window_size=window,
        tie_word_embeddings=getattr(c, "tie_word_embeddings", False),
        qkv_proj_bias=getattr(c, "attention_bias", False),
        out_proj_bias=getattr(c, "attention_bias", False),
        mlp_fc1_bias=False,
        mlp_fc2_bias=False,
        residual_in_fp32=True,
        dtype=dtype,
    )


def remap_state_dict_hf_llama(state_dict: Mapping[str, Any],
                              config: GPTConfig) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``LlamaForCausalLM`` / ``MistralForCausalLM``
    state_dict (torch tensors or numpy arrays) -> this port's
    ``GPTLMHeadModel`` state_dict (≙ the JAX package's models/llama.py:54,
    which builds its flax tree the same way).

    Both sides store Linear weights (out, in), so nothing is transposed:
    q/k/v stack into Wqkv's rows, gate/up into fc1's (GatedMlp splits fc1's
    output as [gate; up]). The embedding and an untied head are padded with
    zero rows to ``config.padded_vocab_size``. Linear and embedding
    weights take ``config.dtype``, norm weights stay fp32. Returns CPU
    tensors for ``load_state_dict``.
    """
    def get(name, dtype=None):
        return torch.as_tensor(state_dict[name]).detach().to(
            "cpu", dtype or config.dtype)

    def padded(name):
        w = get(name)
        extra = config.padded_vocab_size - w.shape[0]
        return torch.cat([w, w.new_zeros(extra, w.shape[1])]) if extra > 0 \
            else w

    sd = {"transformer.embeddings.word_embeddings.weight":
          padded("model.embed_tokens.weight"),
          "transformer.norm_f.weight": get("model.norm.weight",
                                           torch.float32)}
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = padded("lm_head.weight")
    for i in range(config.num_hidden_layers):
        hf, pre = f"model.layers.{i}.", f"transformer.layers.{i}."
        attn = [f"{hf}self_attn.{x}_proj" for x in "qkv"]
        sd[pre + "norm1.weight"] = get(hf + "input_layernorm.weight",
                                       torch.float32)
        sd[pre + "norm2.weight"] = get(hf + "post_attention_layernorm.weight",
                                       torch.float32)
        sd[pre + "mixer.Wqkv.weight"] = torch.cat(
            [get(a + ".weight") for a in attn])
        if config.qkv_proj_bias:
            sd[pre + "mixer.Wqkv.bias"] = torch.cat(
                [get(a + ".bias") for a in attn])
        sd[pre + "mixer.out_proj.weight"] = get(hf + "self_attn.o_proj.weight")
        if config.out_proj_bias:
            sd[pre + "mixer.out_proj.bias"] = get(hf + "self_attn.o_proj.bias")
        sd[pre + "mlp.fc1.weight"] = torch.cat(
            [get(hf + "mlp.gate_proj.weight"), get(hf + "mlp.up_proj.weight")])
        sd[pre + "mlp.fc2.weight"] = get(hf + "mlp.down_proj.weight")
    return sd
