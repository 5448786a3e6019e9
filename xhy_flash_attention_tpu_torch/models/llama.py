"""Llama / Llama-2 / Llama-3 on the GPT skeleton (≙ xhy_flash_attention_tpu
models/llama.py): RMSNorm, SwiGLU MLP, full-head non-interleaved rotary,
GQA, no biases, untied head by default."""

from __future__ import annotations

import torch

from .gpt import GPTConfig

__all__ = ["llama_config_to_gpt_config"]


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
