"""Shared helpers of the attention ops (≙ xhy_flash_attention_tpu
ops/flash_attention/common.py).

The TPU package's `BlockSizes` table is not carried over: it was tuned for
the TPU's vector memory. Tile sizes of the port belong to its kernels
(csrc/*.cu).
"""

from __future__ import annotations

import torch

# Large-but-finite mask value, as in the TPU package: exp(masked - masked)
# never produces NaN.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
NEG_INF = DEFAULT_MASK_VALUE

# Kernel numbers are those of the TPU kernel table (PERF.md section 6,
# ROADMAP.md queue B).
NEXT_SLICES = "(ROADMAP.md, 'Next slices of the port')"
NO_BACKWARD = (
    "attention against a KV cache (dense, paged or split-KV decode) has no "
    "backward, as in the TPU package: call it under torch.no_grad() or "
    "torch.inference_mode()"
)
CUDA_DTYPE_NOT_PORTED = (
    "the CUDA attention kernel (TPU kernels #1 and #5) takes bfloat16 "
    f"q/k/v; fp16 and fp32 come with slice 4 (The rest) {NEXT_SLICES}"
)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def require_inference(*tensors) -> None:
    """Raise when any tensor would need a gradient through a decode
    kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(NO_BACKWARD)
