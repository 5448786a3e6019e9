"""Plain PyTorch reference attention for the numerics contract (≙
xhy_flash_attention_tpu ops/flash_attention/reference.py).

``attention_ref(..., upcast=True)`` is fp32 ground truth;
``attention_ref(..., upcast=False, reorder_ops=True)`` is the deliberately
low-precision baseline. A kernel passes when
``|out - ref| <= 2 * |out_lowprec - ref|`` (plus a small atol).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["FP8_LSE_TOL", "FP8_OUT_TOL", "attention_fp8_ref",
           "attention_ref", "construct_local_mask", "fp8_ref_errors",
           "attention_bwd_tf32x3", "attention_fwd_tf32x3",
           "generate_qkv_segment_ids",
           "matmul_tf32x3", "split_tf32", "sum_bias_members",
           "tf32_trunc"]


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size: Tuple[int, int] = (-1, -1),
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Boolean mask (True = masked out) for causal / sliding-window
    attention, with the causal diagonal aligned to the bottom right: row i
    sees columns [i + sk - sq - left, i + sk - sq + right]."""
    row_idx = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col_idx = torch.arange(seqlen_k, dtype=torch.int64, device=device)[None, :]
    if key_padding_mask is None:
        sk = seqlen_k
    else:
        sk = key_padding_mask.sum(-1)[:, None, None, None]
    if query_padding_mask is None:
        sq = seqlen_q
    else:
        sq = query_padding_mask.sum(-1)[:, None, None, None]
    left, right = window_size
    if left < 0 and right < 0:
        return torch.zeros((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
    masks = []
    if right >= 0:
        masks.append(col_idx > row_idx + sk - sq + right)
    if left >= 0:
        masks.append(col_idx < row_idx + sk - sq - left)
    mask = masks[0]
    for m in masks[1:]:
        mask = mask | m
    return mask


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    reorder_ops: bool = False,
):
    """q: (b, sq, h, d); k/v: (b, sk, hk, d), h % hk == 0.

    Returns (out (b, sq, h, d), attention probabilities (b, h, sq, sk)).
    """
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        if attn_bias is not None:
            attn_bias = attn_bias.float()
    batch, seqlen_q, nheads, head_dim = q.shape
    seqlen_k, nheads_k = k.shape[1], k.shape[2]
    if nheads % nheads_k:
        raise ValueError(f"{nheads} heads do not group over {nheads_k}")
    if nheads_k != nheads:
        k = k.repeat_interleave(nheads // nheads_k, dim=2)
        v = v.repeat_interleave(nheads // nheads_k, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(head_dim)
    if not reorder_ops:
        scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if attn_bias is not None:
        scores = scores + attn_bias
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :], -math.inf)
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, query_padding_mask,
            key_padding_mask, device=q.device)
        scores = scores.masked_fill(local_mask, -math.inf)
    # rows with no visible key give 0 output and 0 probabilities
    row_max = scores.amax(-1, keepdim=True)
    row_max = torch.clamp_min(row_max, torch.finfo(scores.dtype).min)
    unnorm = torch.exp(scores - row_max)
    unnorm = torch.where(torch.isneginf(scores), 0.0, unnorm)
    denom = unnorm.sum(-1, keepdim=True)
    attention = torch.where(
        denom == 0.0, 0.0, unnorm / torch.clamp_min(denom, 1e-30))
    if local_mask is not None:
        all_masked = local_mask.all(-1, keepdim=True)
        attention = torch.where(all_masked, 0.0, attention)
    dropout_scaling = 1.0 / (1.0 - dropout_p)
    attention_drop = attention if dropout_mask is None else torch.where(
        dropout_mask, attention, 0.0)
    output = torch.einsum("bhts,bshd->bthd", attention_drop,
                          v * dropout_scaling)
    if query_padding_mask is not None:
        output = output.masked_fill(~query_padding_mask[:, :, None, None], 0.0)
        attention = attention.masked_fill(
            ~query_padding_mask[:, None, :, None], 0.0)
    return output.to(dtype_og), attention.to(dtype_og)


def generate_qkv_segment_ids(query_padding_mask, key_padding_mask,
                             batch: int, seqlen_q: int, seqlen_k: int):
    """Padding masks (batch, seqlen) bool, True = a token, or None -> int32
    segment ids (q (batch, seqlen_q), k (batch, seqlen_k)): 1 + the batch
    row for tokens, 0 for padding (≙ the JAX package's reference.py:156).
    Drives the segment-id kernel path from padded-batch tests."""
    def ids(mask, seqlen):
        rows = torch.arange(1, batch + 1, dtype=torch.int32)
        if mask is None:
            return rows[:, None].expand(batch, seqlen).contiguous()
        rows = rows.to(mask.device)[:, None]
        return torch.where(mask.to(torch.bool), rows, torch.zeros_like(rows))
    return ids(query_padding_mask, seqlen_q), ids(key_padding_mask, seqlen_k)


def fp8_descales(descales, b: int, hk: int, device) -> torch.Tensor:
    """(q, k, v) descales, each (b, hk) fp32 or None (ones), as one (3, b,
    hk) fp32 tensor on ``device`` (the TPU package's fwd.py:649-655)."""
    return torch.stack([
        torch.ones(b, hk, dtype=torch.float32, device=device) if x is None
        else torch.as_tensor(x, dtype=torch.float32, device=device).reshape(
            b, hk) for x in descales])


def attention_fp8_ref(q, k, v, q_descale=None, k_descale=None,
                      v_descale=None, *, sm_scale: float,
                      causal: bool = False, window_size=(-1, -1),
                      softcap: float = 0.0,
                      need_lse: bool = True):
    """Plain version of the fp8 forward (the e4m3 instantiation of
    csrc/flash_fwd.cu) on (b, h, s, d) float8_e4m3fn tensors, descales (b,
    hk) fp32 or None (ones). Query head i reads the descales of its KV head
    i // (h / hk), q's included (FA3, the TPU package's fwd.py:155-157).

    The kernel's arithmetic: the e4m3 products summed in fp32, then times
    sm_scale * q_descale * k_descale (the "descaled" scores), softcap, the
    window bottom-right aligned (causal: right bound 0), fp32 softmax with
    P rounded to fp16 for P.V (V exact in fp16), the sum divided by the
    row sum and times v_descale, bf16 out. Returns (out (b, h, sq, d)
    bf16, lse (b, h, sq) fp32 of the descaled scores | None); rows that see
    no key give 0 and lse +inf."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    qd, kd, vd = (x.repeat_interleave(g, dim=1)[..., None, None]
                  for x in fp8_descales((q_descale, k_descale, v_descale),
                                        b, hk, q.device))
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * (sm_scale * qd * kd)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    left, right = window_size
    if causal:
        right = 0
    masked = construct_local_mask(sq, sk, (left, right), device=q.device)
    s = s.masked_fill(masked, -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = p.to(torch.float16).float() @ vf
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0) * vd
    lse = None
    if need_lse:
        lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return o.to(torch.bfloat16), lse


# Limits on fp8_ref_errors' two readings, about 4x the largest an H100
# gave over chip_smoke.py phase 15's cases (out 4.7e-5, LSE 2.6e-4;
# PERF.md, PR 14): a 1% fault in a descale reads 4e-3 or more
FP8_OUT_TOL = 2e-4
FP8_LSE_TOL = 1e-3


def fp8_ref_errors(out, lse, ref, ref_lse, q, k, q_descale, k_descale,
                   v_descale, sm_scale: float) -> Tuple[float, float]:
    """The e4m3 kernel's errors against :func:`attention_fp8_ref`, in units
    of the accumulation error it may make. out and ref are (b, sq, h, d),
    lse and ref_lse (b, h, sq), q (b, sq, h, d) and k (b, sk, hk, d)
    float8_e4m3fn, the descales (b, hk) or None (ones).

    The kernel sums its e4m3 products with fewer mantissa bits than fp32,
    so a score is off by a fraction of its products' magnitude, at most
    S = sm_scale * qd * kd * |q row| * max |k row| (Cauchy-Schwarz), and a
    row's LSE by as much; its output, a softmax average of values of
    magnitude V = 448 * v_descale at most (per-head quantization puts the
    largest value on 448), by twice that times V. Beyond that both round
    P to f16 (2^-10 of V between them) and the output to bf16 (2^-7 of
    |ref|), and sum in fp32 in another order (1e-5 of 1 + |LSE|). Returns
    (the largest out error beyond the roundings over S * V of its row, the
    largest LSE error beyond its fp32 term over S); inf when the rows that
    see no key differ."""
    b, _, h, _ = out.shape
    hk = k.shape[2]

    def per_head(x):  # (b, hk) or None -> (b, h)
        x = (torch.ones(b, hk, device=out.device) if x is None
             else x.float().reshape(b, hk))
        return x.repeat_interleave(h // hk, dim=1)
    kmax = per_head(k.float().norm(dim=-1).amax(1))
    score = (sm_scale * per_head(q_descale) * per_head(k_descale) * kmax)[
        ..., None] * q.float().norm(dim=-1).transpose(1, 2)  # (b, h, sq)
    score = score.clamp_min(1e-30)
    vmax = 448.0 * per_head(v_descale)
    diff = ((out.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
            - 2.0 ** -10 * vmax[:, None, :, None])
    out_err = (diff / (score.transpose(1, 2) * vmax[:, None, :])[..., None]
               ).max().item()
    fin = torch.isfinite(ref_lse)
    if not torch.equal(fin, torch.isfinite(lse)):
        return out_err, math.inf
    lse_err = ((lse[fin] - ref_lse[fin]).abs() - 1e-5 * (1 + ref_lse[fin].abs())
               ) / score[fin]
    return out_err, lse_err.max().item() if lse_err.numel() else 0.0


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` as the H100's tensor cores read a .tf32 operand: its
    low 13 mantissa bits ignored (truncation toward zero)."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_trunc takes float32, not {x.dtype}")
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the fp32 attention kernels hand an
    operand to the tensor cores (csrc/hopper.cuh split_tf32): hi is x
    itself, read as tf32(x); lo = x - tf32(x), exact in fp32, read as
    tf32(lo). Returns both as the tensor cores read them, float32 values
    that TF32 holds exactly: x = hi + lo to within 2^-21 |x|. An infinite
    x keeps it in hi, with a nan lo; a nan gives nan in both."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of float32 tensors as the fp32 attention kernels compute
    every product: three TF32 products summed in fp32, the small terms
    apart, (a_lo b_hi + a_hi b_lo) + a_hi b_hi (lo lo dropped). Each
    partial product is an fp32 matmul of values TF32 holds exactly: its
    products are exact and its sums rounded (the tensor cores truncate
    theirs, which the kernels keep short)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention_fwd_tf32x3(q, k, v, *, sm_scale: float, softcap: float = 0.0,
                         mask=None, bias=None, matmul=matmul_tf32x3):
    """The fp32 forward's formulas (csrc/flash_fp32.cu) with both products
    through ``matmul`` (by default the kernel's three TF32 products) on (b,
    h, s, d) float32 tensors: q_s = q * sm_scale; S = q_s K^T, softcap;
    plus ``bias`` in fp32 (a (bb, bh, sq, sk) fp32 or bf16 tensor, bb in
    {1, b}, bh in {1, h}, or None: the BIAS instantiation); -inf where
    ``mask`` (a keep mask broadcastable to (b, h, sq, sk), or None) is
    False; P = exp(S - m) from these scores, m the row max (0 on a row that
    sees no key); O = (P V) / rowsum(P), 0 on such a row; LSE = m +
    log(rowsum), +inf on it. The kernel takes the max and the sums tile by
    tile (online), which moves P by a rounding. Returns (out (b, h, sq, d),
    lse (b, h, sq))."""
    g = q.shape[1] // k.shape[1]
    s = matmul(q * sm_scale, k.repeat_interleave(g, 1).transpose(-1, -2))
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = matmul(p, v.repeat_interleave(g, 1))
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return o, lse


def attention_bwd_tf32x3(q, k, v, out, lse, do, *, sm_scale: float,
                         softcap: float = 0.0, mask=None, bias=None,
                         matmul=matmul_tf32x3):
    """The fp32 backward's formulas (csrc/flash_fp32.cu) with every product
    through ``matmul`` (by default the kernels' three TF32 products) on
    (b, h, s, d) float32 tensors: q_s = q * sm_scale; S = q_s K^T, softcap;
    plus ``bias`` in fp32 (as :func:`attention_fwd_tf32x3`); P = exp(S -
    lse), 0 where ``mask`` (a keep mask broadcastable to (b, h, sq, sk), or
    None) is False; dP = dO V^T; delta = rowsum(dO * out); dS = P (dP -
    delta) (1 - t^2); dV = P^T dO, dK = dS^T q_s (both summed over each KV
    head's group), dQ = dS K sm_scale. Returns (dq, dk, dv), and with a
    bias also dbias: P (dP - delta), before the softcap derivative, summed
    over the bias's broadcast axes as the dbias kernel sums it (each
    element over its (batch, head) pairs in turn, batch first, in fp32;
    :func:`sum_bias_members`), in the bias's (bb, bh, sq, sk) shape and
    dtype."""
    b, h, sq, d = q.shape
    hk = k.shape[1]
    g = h // hk
    qs = q * sm_scale
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = matmul(qs, kr.transpose(-1, -2))
    fac = 1.0
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = t * softcap
        fac = 1.0 - t * t
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = matmul(do, vr.transpose(-1, -2))
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dbias = None if bias is None else sum_bias_members(ds, bias.shape)
    ds = ds * fac
    dv = matmul(p.transpose(-1, -2), do).reshape(b, hk, g, -1, d).sum(2)
    dk = matmul(ds.transpose(-1, -2), qs).reshape(b, hk, g, -1, d).sum(2)
    dq = matmul(ds, kr) * sm_scale
    if bias is None:
        return dq, dk, dv
    return dq, dk, dv, dbias.to(bias.dtype)


def sum_bias_members(ds: torch.Tensor, shape) -> torch.Tensor:
    """(b, h, sq, sk) ``ds`` summed to a bias of ``shape`` (bb, bh, sq, sk),
    bb in {1, b}, bh in {1, h}: each element over the (batch, head) pairs
    that share it, added one pair at a time in the dbias kernels' order
    (every batch for bb 1, every head for bh 1, batch first)."""
    b, h = ds.shape[:2]
    bb, bh = shape[:2]
    out = torch.zeros((bb, bh) + tuple(ds.shape[2:]), dtype=ds.dtype,
                      device=ds.device)
    for bi in range(bb):
        for hi in range(bh):
            for batch in (range(b) if bb == 1 else (bi,)):
                for head in (range(h) if bh == 1 else (hi,)):
                    out[bi, hi] += ds[batch, head]
    return out
