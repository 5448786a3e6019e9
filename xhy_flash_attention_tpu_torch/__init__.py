"""PyTorch / CUDA port of xhy_flash_attention_tpu for NVIDIA Hopper (H100).

The JAX package is the reference; this package mirrors its layout and
names. Each TPU (Pallas) kernel on the ported path has a hand-written CUDA
kernel under ``csrc/``, built at first use (ops/_cuda.py), and a plain
PyTorch version beside its wrapper: CPU tensors take the plain version,
CUDA tensors the kernel. Entry points build models on ``cuda`` unless told
otherwise. This slice serves inference: greedy / sampled decoding of a
Llama-shaped model with a dense KV cache.
"""

from .models.gpt import GPTConfig, GPTLMHeadModel, state_dict_from_jax
from .models.llama import llama_config_to_gpt_config
from .ops.decode import decode_attention
from .ops.flash_attention import attention_ref, flash_attention, flash_attn_func
from .ops.flash_attention.decode_kernel import flash_decode
from .ops.flash_attention.fused_heads import (
    packed_heads_attention,
    packed_qkv_attention,
)
from .ops.layer_norm import (
    dropout_add_layer_norm,
    dropout_add_rms_norm,
    layer_norm,
    rms_norm,
)
from .utils.generation import decode, sample_logits

__all__ = [
    "GPTConfig",
    "GPTLMHeadModel",
    "attention_ref",
    "decode",
    "decode_attention",
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "flash_attention",
    "flash_attn_func",
    "flash_decode",
    "layer_norm",
    "llama_config_to_gpt_config",
    "packed_heads_attention",
    "packed_qkv_attention",
    "rms_norm",
    "sample_logits",
    "state_dict_from_jax",
]
