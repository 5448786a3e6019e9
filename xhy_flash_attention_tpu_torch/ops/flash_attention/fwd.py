"""FlashAttention-2 forward (≙ xhy_flash_attention_tpu
ops/flash_attention/fwd.py `flash_attention_fwd`).

On a CUDA tensor the work runs in csrc/flash_fwd.cu, the counterpart of the
TPU kernel `_fwd_kernel` (fwd.py:78); on a CPU tensor in its plain version
:func:`attention_fwd_ref`. This slice covers causal and full attention,
GQA, softcap and the LSE output. Bias, segment ids, positions, sliding
windows, dropout, FlashMask, block sparsity and fp8 raise
NotImplementedError until their slices.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _cuda
from .common import CUDA_DTYPE_NOT_PORTED, NEXT_SLICES, require_inference

__all__ = ["attention_fwd_ref", "flash_attention_fwd"]


def attention_fwd_ref(q, k, v, *, sm_scale: float, causal: bool,
                      softcap: float, need_lse: bool):
    """Plain version of the kernel on (b, h, s, d) tensors of any strides.

    The same arithmetic as the kernel and the TPU kernels: q scaled in fp32
    and rounded to its dtype, fp32 scores, softcap, bottom-right causal
    mask, fp32 softmax with P rounded to v's dtype for P.V, division by the
    fp32 row sum. Returns (out (b, h, sq, d), lse (b, h, sq) fp32 | None);
    rows that see no key give 0 and lse +inf.
    """
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    qs = (q.float() * sm_scale).to(q.dtype).float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = qs @ kf.transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = p.to(v.dtype).float() @ vf
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    lse = None
    if need_lse:
        lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return o.to(q.dtype), lse


def launch_flash_fwd(q, k, v, out, lse, *, sm_scale: float, causal: bool,
                     softcap: float) -> None:
    """Launch csrc/flash_fwd.cu on (b, h, s, d)-shaped views of any strides
    (head dim contiguous): q, out (b, h, sq, d); k, v (b, hk, sk, d); lse
    (b, h, sq) fp32 contiguous or None. The callers count the launch."""
    tensors = [t for t in (q, k, v, out, lse) if t is not None]
    _cuda.require_cuda(*tensors)
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, out)):
        raise NotImplementedError(CUDA_DTYPE_NOT_PORTED)
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if h % hk or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)}")
    if lse is not None and (lse.shape != (b, h, sq) or not lse.is_contiguous()
                            or lse.dtype != torch.float32):
        raise ValueError("lse must be a contiguous fp32 (b, h, sq) tensor")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _cuda.require_aligned(t, 8, name)
    code = _cuda.lib().xfa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, hk, sq, sk, d, float(sm_scale), float(softcap), int(causal),
        _cuda.stream())
    _cuda.check(code, "flash_fwd")


def _check_supported(causal, window_size, dropout_p, optional) -> bool:
    """Return the effective causal flag; raise on what this slice lacks."""
    left, right = window_size
    if causal:
        right = 0
    flags = {name: value is not None for name, value in optional.items()}
    flags["sliding window"] = left >= 0 or right > 0
    unsupported = [name for name, on in flags.items() if on]
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention_fwd: dropout comes with slice 3 (Training) "
            f"{NEXT_SLICES}")
    if unsupported:
        raise NotImplementedError(
            f"flash_attention_fwd: {', '.join(unsupported)} not ported yet: "
            f"slice 4 (The rest) {NEXT_SLICES}")
    return right == 0


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    dropout_seed=None,
    need_lse: bool = True,
    flashmask_vecs=None,
    block_mask=None,
    q_positions=None,
    kv_positions=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Forward attention on (batch, heads, seq, head_dim) inputs.

    Returns (out, lse): out (b, h, sq, d) in q's dtype, lse (b, h, sq) fp32
    or None. The inputs may be strided views (only the head dim must be
    contiguous). On CUDA, out is allocated in (b, sq, h, d) memory order and
    returned as a (b, h, sq, d) view, so that swapping it back to the
    projection layout is free.

    ``flash_attention_fwd.launches`` counts kernel launches.
    """
    causal = _check_supported(causal, window_size, dropout_p, {
        "bias": bias, "segment ids": q_segment_ids,
        "kv segment ids": kv_segment_ids, "FlashMask": flashmask_vecs,
        "block mask": block_mask, "q positions": q_positions,
        "kv positions": kv_positions})
    if q.dtype == torch.float8_e4m3fn:
        raise NotImplementedError("fp8 attention comes with slice 4 (The rest) "
                                  f"{NEXT_SLICES}")
    require_inference(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                 softcap=softcap, need_lse=need_lse)
    b, h, sq, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    launch_flash_fwd(q, k, v, out, lse, sm_scale=sm_scale, causal=causal,
                     softcap=softcap)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
