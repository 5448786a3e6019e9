from .blocksparse import (
    blockmask_to_dense,
    blocksparse_attention,
    flash_blocksparse_attn_func,
)
from .flashmask import (
    causal_document_mask,
    flashmask_attention,
    flashmask_to_dense,
    global_sliding_window_mask,
    sliding_window_mask,
)
from .common import BlockSizes
from .interface import (
    flash_attention,
    flash_attn_fp8_func,
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    flash_attn_with_kvcache,
)
from .reduced_scores import calc_reduced_attn_scores
from .reference import (attention_ref, construct_local_mask,
                        generate_qkv_segment_ids)

__all__ = ["BlockSizes", "attention_ref", "blockmask_to_dense",
           "blocksparse_attention", "calc_reduced_attn_scores",
           "causal_document_mask", "construct_local_mask", "flash_attention",
           "flash_attn_fp8_func", "flash_attn_func",
           "flash_attn_kvpacked_func",
           "flash_attn_qkvpacked_func", "flash_attn_varlen_func",
           "flash_attn_varlen_kvpacked_func",
           "flash_attn_varlen_qkvpacked_func", "flash_attn_with_kvcache",
           "flash_blocksparse_attn_func", "flashmask_attention",
           "flashmask_to_dense", "generate_qkv_segment_ids",
           "global_sliding_window_mask", "sliding_window_mask"]
