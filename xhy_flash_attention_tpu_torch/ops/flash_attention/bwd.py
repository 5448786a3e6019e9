"""FlashAttention-2 backward (≙ xhy_flash_attention_tpu
ops/flash_attention/bwd.py `flash_attention_bwd`).

On CUDA tensors the work runs in csrc/flash_bwd.cu as JAX's deterministic
split pair: the dK/dV kernel (the counterpart of the TPU kernel
`_bwd_dkv_kernel`, bwd.py:180) and the dQ kernel (`_bwd_dq_kernel`,
bwd.py:511), each with its own launch count. delta = rowsum(dO * O) is a
plain PyTorch reduction, as JAX leaves it to XLA (bwd.py:736-737). On CPU
tensors the plain version :func:`attention_bwd_ref` runs. Covered: causal
and full attention, GQA, softcap, FlashMask and block-sparse masks (both
kernels skip the tiles the forward skips); windows raise until slice 5.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _cuda
from .common import (BWD_DKV_KEY_TILE, CUDA_DTYPE_NOT_PORTED, SLICE_VARLEN,
                     KernelMasks, bwd_dq_key_tile, dense_keep_mask,
                     expand_heads)

__all__ = ["attention_bwd_ref", "flash_attention_bwd", "flash_bwd_dkv",
           "flash_bwd_dq", "launch_flash_bwd"]


def attention_bwd_ref(q, k, v, out, lse, do, *, sm_scale: float,
                      causal: bool, softcap: float, mask=None):
    """Plain version of the kernels on (b, h, s, d) tensors of any strides.

    P = exp(S - LSE) is rebuilt from the forward's LSE with the forward's
    rounding: q scaled in fp32 and rounded to its dtype; P rounded to v's
    dtype for dV, dS to q's dtype for dK and dQ (bwd.py:106-177, 440-470).
    ``mask``: the forward's dense keep mask (b|1, hm|1, sq, sk) or None.
    Returns (dq, dk, dv) in the inputs' dtypes, dk/dv summed over the GQA
    group.
    """
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    dt = q.dtype
    qs = (q.float() * sm_scale).to(dt)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = qs.float() @ kf.transpose(-1, -2)
    th = None
    if softcap > 0.0:
        th = torch.tanh(s / softcap)
        s = th * softcap
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), -math.inf)
    if mask is not None:
        s = s.masked_fill(~expand_heads(mask, h), -math.inf)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    delta = (dof * out.float()).sum(-1, keepdim=True)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    p = p.to(v.dtype).float()
    ds = ds.to(dt).float()
    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qs.float()
    dq = (ds @ kf) * sm_scale
    if g > 1:
        dk = dk.reshape(b, hk, g, sk, d).sum(2)
        dv = dv.reshape(b, hk, g, sk, d).sum(2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(q, k, v, do, lse, dq, dk, dv):
    b, h, sq, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, do, dq, dk, dv)):
        raise NotImplementedError(CUDA_DTYPE_NOT_PORTED)
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernels take 64 or 128")
    if (h % k.shape[1] or v.shape != k.shape or do.shape != q.shape
            or dq.shape != q.shape or dk.shape != k.shape
            or dv.shape != k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do {tuple(do.shape)}")
    if lse.shape != (b, h, sq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32:
        raise ValueError("lse must be a contiguous fp32 (b, h, sq) tensor")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do"), (dq, "dq"),
                    (dk, "dk"), (dv, "dv")):
        _cuda.require_aligned(t, 8, name)


def launch_flash_bwd(which: str, q, k, v, do, lse, delta, dq, dk, dv, *,
                     sm_scale: float, causal: bool, softcap: float,
                     masks: KernelMasks = None) -> None:
    """Launch one kernel of csrc/flash_bwd.cu (``which``: "dkv" writes dk
    and dv, "dq" writes dq) on (b, h, s, d)-shaped views of any strides
    (head dim contiguous): q, do, dq (b, h, sq, d); k, v, dk, dv (b, hk, sk,
    d); lse and delta (b, h, sq) fp32 contiguous; ``masks`` the forward's
    FlashMask and block-mask flags, or None. The callers count the
    launch."""
    _cuda.require_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                       *(masks.tensors() if masks is not None else ()))
    _check_shapes(q, k, v, do, lse, dq, dk, dv)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    fn = {"dkv": _cuda.lib().xfa_flash_bwd_dkv,
          "dq": _cuda.lib().xfa_flash_bwd_dq}[which]
    key_tile = BWD_DKV_KEY_TILE if which == "dkv" else bwd_dq_key_tile(d)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(),
              *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]),
              b, h, hk, sq, sk, d, float(sm_scale), float(softcap),
              int(causal), *KernelMasks.c_args(masks, key_tile),
              _cuda.stream())
    _cuda.check(code, f"flash_bwd_{which}")


def attention_delta(out, do):
    """delta = rowsum(dO * O) in fp32, (b, h, sq) contiguous."""
    return (do.float() * out.float()).sum(-1).contiguous()


def flash_bwd_dkv(q, k, v, do, lse, delta, dq, dk, dv, **kw) -> None:
    """The dK/dV kernel (TPU kernel #2); ``flash_bwd_dkv.launches`` counts
    its launches."""
    launch_flash_bwd("dkv", q, k, v, do, lse, delta, dq, dk, dv, **kw)
    flash_bwd_dkv.launches += 1


def flash_bwd_dq(q, k, v, do, lse, delta, dq, dk, dv, **kw) -> None:
    """The dQ kernel (TPU kernel #3); ``flash_bwd_dq.launches`` counts its
    launches."""
    launch_flash_bwd("dq", q, k, v, do, lse, delta, dq, dk, dv, **kw)
    flash_bwd_dq.launches += 1


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, sm_scale: float,
                        causal: bool = False,
                        window_size: Tuple[int, int] = (-1, -1),
                        softcap: float = 0.0, flashmask_vecs=None,
                        flashmask_mode=None, block_mask=None):
    """Backward attention on (batch, heads, seq, head_dim) tensors.

    Returns (dq, dk, dv) with dk/dv reduced over the GQA group (the shape of
    k/v). On CUDA the gradients are allocated in (b, s, h, d) memory order
    and returned as (b, h, s, d) views, like the forward's output. The mask
    flags are the forward's (fwd.py `flash_attention_fwd`).
    """
    left, right = window_size
    if causal:
        right = 0
    if left >= 0 or right > 0:
        raise NotImplementedError(
            f"flash_attention_bwd: sliding window not ported yet: "
            f"{SLICE_VARLEN}")
    causal = right == 0
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    mask_kw = dict(flashmask_vecs=flashmask_vecs,
                   flashmask_mode=flashmask_mode, block_mask=block_mask)
    masks = KernelMasks(b, h, sq, sk, **mask_kw)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, do, sm_scale=sm_scale,
                                 causal=causal, softcap=softcap,
                                 mask=dense_keep_mask(sq, sk, h, **mask_kw))

    def grad_like(n, s):
        return torch.empty(b, s, n, d, dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(h, sq), grad_like(hk, sk), grad_like(hk, sk)
    do = _cuda.aligned(do, 8)
    delta = attention_delta(out, do)
    kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap, masks=masks)
    flash_bwd_dkv(q, k, v, do, lse, delta, dq, dk, dv, **kw)
    flash_bwd_dq(q, k, v, do, lse, delta, dq, dk, dv, **kw)
    return dq, dk, dv
