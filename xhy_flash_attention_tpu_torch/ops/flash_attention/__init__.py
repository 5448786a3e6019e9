from .interface import flash_attention, flash_attn_func
from .reference import attention_ref, construct_local_mask

__all__ = ["attention_ref", "construct_local_mask", "flash_attention",
           "flash_attn_func"]
