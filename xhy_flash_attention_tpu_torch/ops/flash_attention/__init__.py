from .interface import (
    flash_attention,
    flash_attn_func,
    flash_attn_qkvpacked_func,
    flash_attn_with_kvcache,
)
from .reference import attention_ref, construct_local_mask

__all__ = ["attention_ref", "construct_local_mask", "flash_attention",
           "flash_attn_func", "flash_attn_qkvpacked_func",
           "flash_attn_with_kvcache"]
