"""PyTorch / CUDA port of xhy_flash_attention_tpu for NVIDIA Hopper (H100).

The JAX package is the reference; this package mirrors its layout and
names. Each TPU (Pallas) kernel on the ported path has a hand-written CUDA
kernel under ``csrc/``, built at first use (ops/_cuda.py), and a plain
PyTorch version beside its wrapper: CPU tensors take the plain version,
CUDA tensors the kernel. Entry points build models on ``cuda`` unless told
otherwise. The ported slices: greedy / sampled decoding of a Llama-shaped
model with a dense bf16, fp32, int8 or e4m3 KV cache,
`flash_attn_with_kvcache`, continuous-batching serving over paged KV caches
(``inference``: InferenceEngine, PagedKVCache, split-KV decode), and
training on one device (``training``: Trainer, train, AdamW, the
cross-entropy loss), with backward kernels for attention and the fused
norm, sparse-mask attention (``flashmask_attention``,
``blocksparse_attention``, forward and backward) with
``calc_reduced_attn_scores``, and sliding windows, segment ids and q/kv
positions with the varlen and kv-packed entry points and ``bert_padding``,
the attention bias, the fp8 prefill (``flash_attn_fp8_func``),
rematerialised training (``GPTConfig.remat``), weight-only int8 / int4
serving (``GPTConfig.weight_quant``, ``quantize_gpt_params``), fp32
attention kernels (models run in bfloat16 or float32 on the card), and
GPT-2 from Hugging Face or Megatron-LM weights
(``gpt2_config_to_gpt_config``, ``remap_state_dict_hf_gpt2``,
``remap_state_dict_megatron``; ``utils.pretrained`` reads local files),
GPT-NeoX (``gpt_neox_config_to_gpt_config``, ``remap_state_dict_hf_gpt_neox``;
the parallel block), and dropout, rowscale and layerscale in the fused
norm with its parallel-residual and subset forms.
"""

from .bert_padding import (
    index_first_axis,
    index_first_axis_residual,
    index_put_first_axis,
    pad_input,
    unpad_input,
)
from .losses import CrossEntropyLoss, cross_entropy_loss
from .models.gpt import (GPTConfig, GPTLMHeadModel, gpt2_config_to_gpt_config,
                         quantize_gpt_params, remap_state_dict_hf_gpt2,
                         remap_state_dict_megatron, state_dict_from_jax)
from .models.gpt_neox import (gpt_neox_config_to_gpt_config,
                              remap_state_dict_hf_gpt_neox)
from .models.llama import (llama_config_to_gpt_config,
                           remap_state_dict_hf_llama)
from .ops.decode import decode_attention
from .ops.flash_attention import (
    BlockSizes,
    attention_ref,
    blockmask_to_dense,
    blocksparse_attention,
    calc_reduced_attn_scores,
    causal_document_mask,
    flash_attention,
    flash_attn_fp8_func,
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    flash_attn_with_kvcache,
    flash_blocksparse_attn_func,
    flashmask_attention,
    flashmask_to_dense,
    global_sliding_window_mask,
    sliding_window_mask,
)
from .ops.flash_attention.decode_kernel import flash_decode
from .ops.flash_attention.fused_heads import (
    packed_heads_attention,
    packed_qkv_attention,
)
from .ops.layer_norm import (
    dropout_add_layer_norm,
    dropout_add_layer_norm_parallel_residual,
    dropout_add_layer_norm_subset,
    dropout_add_rms_norm,
    dropout_add_rms_norm_parallel_residual,
    layer_norm,
    rms_norm,
)
from .training import Trainer, train
from .utils.generation import decode, sample_logits

__all__ = [
    "BlockSizes",
    "CrossEntropyLoss",
    "GPTConfig",
    "GPTLMHeadModel",
    "Trainer",
    "attention_ref",
    "blockmask_to_dense",
    "blocksparse_attention",
    "calc_reduced_attn_scores",
    "causal_document_mask",
    "cross_entropy_loss",
    "decode",
    "decode_attention",
    "dropout_add_layer_norm",
    "dropout_add_layer_norm_parallel_residual",
    "dropout_add_layer_norm_subset",
    "dropout_add_rms_norm",
    "dropout_add_rms_norm_parallel_residual",
    "flash_attention",
    "flash_attn_fp8_func",
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_with_kvcache",
    "flash_blocksparse_attn_func",
    "flash_decode",
    "flashmask_attention",
    "flashmask_to_dense",
    "global_sliding_window_mask",
    "gpt2_config_to_gpt_config",
    "gpt_neox_config_to_gpt_config",
    "index_first_axis",
    "index_first_axis_residual",
    "index_put_first_axis",
    "layer_norm",
    "llama_config_to_gpt_config",
    "packed_heads_attention",
    "packed_qkv_attention",
    "pad_input",
    "quantize_gpt_params",
    "remap_state_dict_hf_gpt2",
    "remap_state_dict_hf_gpt_neox",
    "remap_state_dict_hf_llama",
    "remap_state_dict_megatron",
    "rms_norm",
    "sample_logits",
    "sliding_window_mask",
    "state_dict_from_jax",
    "train",
    "unpad_input",
]
