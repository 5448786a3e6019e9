"""FlashAttention-2 backward (≙ xhy_flash_attention_tpu
ops/flash_attention/bwd.py `flash_attention_bwd`).

On CUDA tensors the work runs in csrc/flash_bwd.cu as JAX's deterministic
split pair: the dK/dV kernel (the counterpart of the TPU kernel
`_bwd_dkv_kernel`, bwd.py:180) and the dQ kernel (`_bwd_dq_kernel`,
bwd.py:511), each with its own launch count, after a pre-pass kernel
(:func:`flash_bwd_prep`) that writes delta = rowsum(dO * O), which JAX
leaves to XLA (bwd.py:736-737), and q_s = q * sm_scale in bf16. The kernels
are persistent CTAs fed by TMA rings, on wgmma; :func:`bwd_dkv_tile_plan`,
:func:`bwd_dq_tile_plan` and :func:`bwd_schedule` mirror what they visit.
A FlashMask or block mask runs their masked instantiations, whose producer
decides from the mask which tiles each block visits
(:func:`bwd_masked_dkv_tile_plan`, :func:`bwd_masked_dq_tile_plan`). On
CPU tensors the plain version :func:`attention_bwd_ref` runs. Covered:
causal and full attention, GQA, softcap, FlashMask and block-sparse masks,
sliding windows, segment ids and q/kv positions (the masked
instantiations), and an attention bias with its gradient: the kernels'
bias instantiations read the bias to rebuild P, and dbias, summed over the
batches and heads that share each bias element, comes from a kernel of its
own (:func:`flash_bwd_dbias`, csrc/flash_bwd_dbias.cu) in a fixed order,
with no atomics and no workspace beyond dbias itself. float32 tensors run
csrc/flash_fp32.cu's dK/dV and dQ kernels (every product as three TF32
products on the tensor cores, fp32-accurate, bitwise repeatable;
:func:`flash_bwd_dkv_fp32`, :func:`flash_bwd_dq_fp32`, and through
:func:`launch_flash_bwd` the packed layout) after the pre-pass's fp32
instantiation, with causal, windows, softcap and GQA, under a FlashMask,
block mask, segment ids or positions their masked instantiations (the
tiles :func:`bwd_masked_dkv_tile_plan` and :func:`bwd_masked_dq_tile_plan`
with ``fp32`` mirror), and with a bias their bias instantiations, with
dbias from flash_fp32.cu's own dbias kernel (:func:`flash_bwd_dbias_fp32`,
which :func:`flash_bwd_dbias` runs for fp32 q_s), by the bf16 kernel's
rules. With the forward's dropout (a :class:`common.Dropout`) the bf16
kernels' dropout instantiations regenerate its keep mask element by
element (dP masked and scaled, dV from the dropped P; the pre-pass is
unchanged, since O already carries the dropout).
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import torch

from .. import _cuda
from .common import (CUDA_DTYPE_NOT_PORTED, Dropout, KernelMasks, cdiv,
                     expand_heads)
from .common import kernel_tiles
from .fwd import (F32, MASK_PART, MaskTiles, bias_view, build_masks,
                  check_supported, check_tile_counts, cut_to_range,
                  dropout_instance, elementwise_first, fp32_window,
                  kernel_bias, key_tile_plan,
                  masked_counters, masked_row_block_plan, masked_window,
                  pair_schedule)

__all__ = ["attention_bwd_ref", "bwd_dkv_tile_plan", "bwd_dq_tile_plan",
           "bwd_dkv_window_plan", "bwd_masked_dkv_tile_plan",
           "bwd_masked_dq_tile_plan",
           "bwd_prep_ref", "bwd_schedule", "flash_attention_bwd",
           "flash_bwd_dbias", "flash_bwd_dbias_fp32", "flash_bwd_dkv",
           "flash_bwd_dkv_fp32",
           "flash_bwd_dq", "flash_bwd_dq_fp32", "flash_bwd_prep",
           "launch_flash_bwd", "launch_flash_bwd_fp32"]

# Tiles of the kernels, csrc/flash_bwd.cu: a dK/dV block of BWD_DKV_TILE_N
# keys streams query tiles of BWD_DKV_TILE_M rows (kDkvKeys, kDkvRows); a dQ
# block of BWD_DQ_TILE_M rows streams key tiles of bwd_dq_tile_n(d) keys
# (kDqRows, dq_keys). Under a mask each consumer computes a part of
# fwd.MASK_PART keys (dK/dV) or rows (dQ), and a dQ tile of 128 keys has two
# parts.
BWD_DKV_TILE_N = 128
BWD_DKV_TILE_M = 64
BWD_DQ_TILE_M = 128


def bwd_dq_tile_n(d: int) -> int:
    return 128 if d == 64 else 64


def query_window(n0: int, sq: int, sk: int, window, m: int = BWD_DKV_TILE_M,
                 n: int = BWD_DKV_TILE_N, rng=None):
    """(first, f0, f1, end) of the key block of ``n`` keys at n0 under the
    row/key window (left, right) (csrc/common.cuh `query_window`; for
    causal `query_tiles`): the query tiles of ``m`` rows [first, end) hold
    a row that may see a key of the block below sk, cut to the tile range
    ``rng`` (lo, hi) when given; [f0, f1) among them are free: every row
    below sq sees every such key."""
    left, right = window
    off = sk - sq
    k0, k1 = n0, min(n0 + n, sk) - 1
    rmin = 0 if right < 0 else max(0, k0 - off - right)
    rmax = sq - 1 if left < 0 else min(sq - 1, k1 - off + left)
    if rmax < rmin:
        return 0, 0, 0, 0
    first, end = cut_to_range(rmin // m, rmax // m + 1, rng)
    free_from = 0 if right < 0 else max(0, k1 - off - right)
    f0 = min(max(cdiv(free_from, m), first), end)
    t_end = sq // m
    if left >= 0:
        t_end = min(t_end, max(0, (k0 - off + left + 1) // m))
    return first, f0, min(max(t_end, f0), end), end


def query_tile_order(first: int, f0: int, f1: int, end: int):
    """Candidates of a dK/dV block in the kernel's order (common.cuh
    QueryTilePlan::tile): (tile, masked), the masked ones [first, f0) and
    [f1, end) first, then the free ones [f0, f1)."""
    return ([(t, True) for t in range(first, f0)]
            + [(t, True) for t in range(f1, end)]
            + [(t, False) for t in range(f0, f1)])


def bwd_dkv_window_plan(sq: int, sk: int, window):
    """The query tiles the dK/dV kernel considers for each block of
    BWD_DKV_TILE_N keys under a row/key window (:func:`query_window`), the
    same for every head of a group: (tile index, masked) in visit order.
    Tile t holds rows [t * BWD_DKV_TILE_M, (t + 1) * BWD_DKV_TILE_M)."""
    return [query_tile_order(*query_window(n0, sq, sk, window))
            for n0 in range(0, sk, BWD_DKV_TILE_N)]


def bwd_dkv_tile_plan(sq: int, sk: int, causal: bool):
    """The query tiles the dense dK/dV kernel visits (csrc/flash_bwd.cu
    `dkv_plan`), the same for every head of a group: for each block of
    BWD_DKV_TILE_N keys, a list of (tile index, masked) in visit order.
    Tile t holds rows [t * BWD_DKV_TILE_M, (t + 1) * BWD_DKV_TILE_M). The
    masked ones come first: the causal diagonal tiles, ascending, then the
    ragged last tile; then the others, ascending, which run no elementwise
    test: every row is below sq and sees every key of the block below sk
    (keys past sk are not written, so they do not count)."""
    return bwd_dkv_window_plan(sq, sk, (-1, 0 if causal else -1))


def bwd_dq_tile_plan(sq: int, sk: int, causal: bool, d: int):
    """The key tiles the dense dQ kernel visits at head dim ``d``: for each
    block of BWD_DQ_TILE_M rows, (tile index, masked) of bwd_dq_tile_n(d)
    keys, last tile first, the masked ones first (fwd.py
    :func:`key_tile_plan`)."""
    return key_tile_plan(sq, sk, causal, BWD_DQ_TILE_M, bwd_dq_tile_n(d))


def bwd_masked_dkv_tile_plan(masks: KernelMasks, b: int, h: int, hk: int,
                             sq: int, sk: int, causal: bool, d: int = 64,
                             fp32: bool = False):
    """The query tiles the masked dK/dV kernel visits (csrc/flash_bwd.cu
    ``dkv_tile_flags`` and its producer): for each block (batch, kv head,
    key block of BWD_DKV_TILE_N keys), a list of (head in the group, tile,
    elementwise, parts) in visit order. The candidates of each head are
    :func:`bwd_dkv_window_plan`'s under the masked window, cut to the
    block's range of query tiles from the segment and position stats; a
    tile is skipped when the FlashMask stats of the block's keys or the
    segment / position stats mask its rows everywhere, or when neither
    part (the block's keys [0, 64) and [64, 128), a consumer's each; a part
    past sk is off) has its block-mask entry on. ``elementwise``: the
    plan's window / ragged test, the FlashMask band test (not bypassed) or
    the segment / position test; those tiles come first within a head,
    then the others, each in candidate order. With ``fp32`` the fp32
    kernel's at head dim ``d`` (:func:`common.kernel_tiles` "dkv_fp32":
    query tiles of 32 rows against key blocks of 128 keys at d 64, 16
    against 64 at d 128, where both consumers take the block's 64 keys:
    both parts are the one block-mask entry's)."""
    kind = "dkv_fp32" if fp32 else "dkv"
    m, n = kernel_tiles(kind, d)
    mt = MaskTiles(masks, h, n, m, kind, d)
    g = h // hk
    window = masked_window(masks, causal)
    plan = {}
    for nb, n0 in enumerate(range(0, sk, n)):
        part_keys = (n0, n0 + MASK_PART) if n == 2 * MASK_PART else (n0, n0)
        for batch in range(b):
            cands = query_tile_order(*query_window(
                n0, sq, sk, window, m, n, rng=mt.range(batch, nb)))
            for kv_head in range(hk):
                tiles = []
                for gi in range(g):
                    head = kv_head * g + gi
                    found = []
                    for t, masked in cands:
                        skip, bypass = mt.decide(batch, head, t * m,
                                                 min(t * m + m, sq), n0)
                        tok = mt.tokens(batch, t * m, n0)
                        parts = tuple(key < sk and mt.on(batch, head, t * m, key)
                                      for key in part_keys)
                        if not skip and tok >= 0 and any(parts):
                            found.append((gi, t, masked or not bypass
                                          or tok > 0, parts))
                    tiles += elementwise_first(found, 2)
                plan[(batch, kv_head, nb)] = tiles
    return plan


def bwd_masked_dq_tile_plan(masks: KernelMasks, b: int, h: int, hk: int,
                            sq: int, sk: int, causal: bool, d: int,
                            fp32: bool = False):
    """The key tiles the masked dQ kernel visits at head dim ``d``
    (csrc/flash_bwd.cu, common.cuh ``row_block_tile_flags`` and the
    producer): fwd.py :func:`masked_row_block_plan` over key tiles of
    bwd_dq_tile_n(d) keys, or with ``fp32`` of the fp32 kernel's
    (csrc/flash_fp32.cu, :func:`common.kernel_tiles` "dq_fp32") (``hk`` is
    not needed: each query head is its own block)."""
    del hk
    kind = "dq_fp32" if fp32 else "dq"
    return masked_row_block_plan(masks, b, h, sq, sk, causal,
                                 kernel_tiles(kind, d)[1], kind, d)


def bwd_schedule(which: str, sq: int, sk: int, h: int, hk: int, b: int,
                 ctas: int):
    """The dense kernels' persistent schedules (fwd.py
    :func:`pair_schedule`): for each of ``ctas`` CTAs, in order, the
    (batch, kv head, key block) blocks of the dK/dV kernel (``which`` "dkv";
    block j, the heavier under a causal mask, then block n - 1 - j) or the
    (batch, head, query block) blocks of the dQ kernel ("dq"; block
    n - 1 - j first)."""
    if which == "dkv":
        return pair_schedule(cdiv(sk, BWD_DKV_TILE_N), hk, b, ctas, False)
    return pair_schedule(cdiv(sq, BWD_DQ_TILE_M), h, b, ctas, True)


def attention_bwd_ref(q, k, v, out, lse, do, *, sm_scale: float,
                      causal: bool, softcap: float, mask=None, bias=None,
                      dropout: Optional[Dropout] = None):
    """Plain version of the kernels on (b, h, s, d) tensors of any strides.

    P = exp(S - LSE) is rebuilt from the forward's LSE with the forward's
    rounding: q scaled in fp32 and rounded to its dtype; P rounded to v's
    dtype for dV, dS to q's dtype for dK and dQ (bwd.py:106-177, 440-470).
    ``mask``: the forward's dense keep mask (b|1, hm|1, sq, sk) or None.
    ``bias``: the forward's (bb, bh, sq, sk) bias (fwd.bias_view) or None.
    Returns (dq, dk, dv) in the inputs' dtypes, dk/dv summed over the GQA
    group; with a bias also dbias = P (dP - delta) (the scores' gradient
    before the softcap derivative: the bias enters after softcap), summed
    in fp32 over the axes it broadcasts, (bb, bh, sq, sk) in its dtype.
    With ``dropout`` (the forward's :class:`common.Dropout`), as the TPU
    kernels (bwd.py:158-172): dP is 0 where the mask drops and scaled by
    1 / (1 - p) where it keeps, dS = P (dP - delta) with the undropped P,
    and dV takes the dropped P, its scale applied to dV (the kernel's
    epilogue).
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
    if bias is not None:
        s = s + bias.float()
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
    if dropout is not None:
        keep = dropout.keep(b, h, sq, sk, q.device)
        dp = torch.where(keep, dp * dropout.scale, 0.0)
    ds = p * (dp - delta)
    dbias = None
    if bias is not None:
        dims = tuple(i for i in (0, 1) if bias.shape[i] < ds.shape[i])
        dbias = (ds.sum(dims, keepdim=True) if dims else ds).to(bias.dtype)
    if th is not None:
        ds = ds * (1.0 - th * th)
    if dropout is not None:
        p = p.masked_fill(~keep, 0.0)
    p = p.to(v.dtype).float()
    ds = ds.to(dt).float()
    dv = p.transpose(-1, -2) @ dof
    if dropout is not None:
        dv = dv * dropout.scale
    dk = ds.transpose(-1, -2) @ qs.float()
    dq = (ds @ kf) * sm_scale
    if g > 1:
        dk = dk.reshape(b, hk, g, sk, d).sum(2)
        dv = dv.reshape(b, hk, g, sk, d).sum(2)
    grads = dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)
    return grads if bias is None else grads + (dbias,)


def _check_shapes(q, k, v, do, lse, dq, dk, dv, dtype=torch.bfloat16):
    b, h, sq, d = q.shape
    if any(t.dtype != dtype for t in (q, k, v, do, dq, dk, dv)):
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
        _cuda.require_aligned(t, 16 // t.element_size(), name)


def launch_flash_bwd_fp32(which: str, q, k, v, do, lse, delta, dq, dk, dv,
                          *, sm_scale: float, window, softcap: float,
                          masks: KernelMasks = None, causal: bool = False,
                          tile_counts=None, bias=None) -> None:
    """Launch one kernel of csrc/flash_fp32.cu's backward (``which``: "dkv"
    writes dk and dv, "dq" writes dq) on (b, h, s, d) float32 views of any
    strides (head dim contiguous, pointers and strides multiples of 16
    bytes): q is q_s = q * sm_scale in fp32 (:func:`flash_bwd_prep`); the
    others as :func:`launch_flash_bwd`; ``window`` (left, right) as
    fwd.fp32_window gives it; ``masks`` and ``causal`` the forward's (a
    FlashMask, block mask, segment ids or positions run the masked
    instantiation, its counters into ``tile_counts`` when given, as
    :func:`bwd_masked_dkv_tile_plan` / :func:`bwd_masked_dq_tile_plan` with
    ``fp32`` count them); ``bias`` the forward's (bb, bh, sq, sk) fp32 or
    bf16 bias or None (the bias instantiation, which reads it to rebuild
    P; dbias is :func:`flash_bwd_dbias_fp32`'s). The callers count the
    launch."""
    _cuda.require_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                       *(masks.tensors() if masks is not None else ()),
                       *(() if bias is None else (bias,)))
    _check_shapes(q, k, v, do, lse, dq, dk, dv, F32)
    check_tile_counts(tile_counts, q.device)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    bias, bias_args = kernel_bias(bias, masks, b, h, sq, sk)
    if min(sq, sk) == 0:  # no pair: zero gradients
        for t in ((dk, dv) if which == "dkv" else (dq,)):
            t.zero_()
        return
    counters = masked_counters(masks, tile_counts, q.device, fp32=True)
    code = _cuda.lib().xfa_flash_bwd_fp32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]),
        b, h, hk, sq, sk, d, float(sm_scale), float(softcap),
        int(window[0]), int(window[1]), {"dkv": 0, "dq": 1}[which],
        *KernelMasks.c_args(masks if counters is not None else None, causal,
                            which + "_fp32", d),
        _cuda.ptr(masks.bands() if counters is not None else None),
        _cuda.ptr(counters), *bias_args, _cuda.stream())
    _cuda.check(code, f"flash_bwd_{which}_fp32")


def launch_flash_bwd(which: str, q, k, v, do, lse, delta, dq, dk, dv, *,
                     sm_scale: float, causal: bool, softcap: float,
                     masks: KernelMasks = None, tile_counts=None,
                     bias=None, dropout: Optional[Dropout] = None) -> None:
    """Launch one kernel of csrc/flash_bwd.cu (``which``: "dkv" writes dk
    and dv, "dq" writes dq) on (b, h, s, d)-shaped views of any strides
    (head dim contiguous, pointers and strides multiples of 16 bytes): q,
    do, dq (b, h, sq, d); k, v, dk, dv (b, hk, sk, d); lse and delta (b, h,
    sq) fp32 contiguous; ``masks`` the forward's FlashMask and block-mask
    flags, or None. ``q`` is q_s, the pre-pass's bf16(q * sm_scale)
    (:func:`flash_bwd_prep`). A mask runs the masked instantiation, whose
    blocks come from a counter in device memory (the heavier first); its
    three int32 counters are written to ``tile_counts`` when it is given
    (a contiguous int32 tensor of 3 on the card): the scheduler's, then
    the tiles the kernel visited and those of them with the elementwise
    test, as :func:`bwd_masked_dkv_tile_plan` / :func:`bwd_masked_dq_tile_plan`
    count them. ``bias``: the forward's (bb, bh, sq, sk) bias or None; it
    runs the bias instantiations, which read it to rebuild P (dbias is
    :func:`flash_bwd_dbias`'s). ``dropout``: the forward's
    :class:`common.Dropout` or None; it runs the dropout instantiations
    (bf16, no bias), which regenerate the forward's keep mask in the
    accumulators (dP masked and scaled, dV's P dropped, its scale in the
    epilogue); ``launch_flash_bwd.dropout_launches`` counts their
    launches by kernel and instantiation ("dkv d64", "dq d128 masked").
    float32 tensors go to :func:`launch_flash_bwd_fp32` (the bias too).
    The callers count the launch."""
    if dropout is not None:
        check_supported(q, bias, dropout.p, f"flash_bwd_{which}")
    if q.dtype == F32:
        launch_flash_bwd_fp32(which, q, k, v, do, lse, delta, dq, dk, dv,
                              sm_scale=sm_scale, softcap=softcap,
                              window=fp32_window(masks, causal),
                              masks=masks, causal=causal,
                              tile_counts=tile_counts, bias=bias)
        return
    _cuda.require_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                       *(masks.tensors() if masks is not None else ()),
                       *(() if bias is None else (bias,)))
    _check_shapes(q, k, v, do, lse, dq, dk, dv)
    check_tile_counts(tile_counts, q.device)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if min(sq, sk) == 0:  # no pair: zero gradients
        for t in ((dk, dv) if which == "dkv" else (dq,)):
            t.zero_()
        return
    fn = {"dkv": _cuda.lib().xfa_flash_bwd_dkv,
          "dq": _cuda.lib().xfa_flash_bwd_dq}[which]
    masked = masks is not None and masks.active
    bias, bias_args = kernel_bias(bias, masks, b, h, sq, sk)
    counters = masked_counters(masks, tile_counts, q.device)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(),
              *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]),
              b, h, hk, sq, sk, d, float(sm_scale), float(softcap),
              int(causal), *KernelMasks.c_args(masks, causal, which, d),
              _cuda.ptr(masks.bands() if masked else None),
              _cuda.ptr(counters), *bias_args, *Dropout.c_args(dropout),
              _cuda.stream())
    _cuda.check(code, f"flash_bwd_{which}")
    if dropout is not None:
        launch_flash_bwd.dropout_launches[
            f"{which} {dropout_instance(d, masked)}"] += 1


launch_flash_bwd.dropout_launches = collections.Counter()


def flash_bwd_dbias(q, k, v, do, lse, delta, bias, *, causal: bool,
                    softcap: float, masks: KernelMasks = None):
    """The bias gradient (the dbias output of TPU kernel #2): dbias = P (dP
    - delta), the scores' gradient before the softcap derivative, summed in
    fp32 over the batches and heads that share each element of the (bb,
    bh, sq, sk) ``bias`` (fwd.bias_view), in a fixed order, and returned
    as a (bb, bh, sq, sk) tensor of its dtype (a view of a buffer whose
    rows are padded to an even length when sk is odd; the kernel writes
    key pairs). ``q`` is q_s, the pre-pass's q * sm_scale: bf16 runs
    csrc/flash_bwd_dbias.cu, counted by ``flash_bwd_dbias.launches``;
    float32 runs :func:`flash_bwd_dbias_fp32`. k, v, do, lse and delta as
    :func:`launch_flash_bwd`. Pairs that the masks hide and tiles the
    row/key window skips get 0."""
    if q.dtype == F32:
        return flash_bwd_dbias_fp32(q, k, v, do, lse, delta, bias,
                                    causal=causal, softcap=softcap,
                                    masks=masks)
    dbias = _launch_dbias("xfa_flash_bwd_dbias", q, k, v, do, lse, delta,
                          bias, causal, softcap, masks, torch.bfloat16, "dq")
    flash_bwd_dbias.launches += 1
    return dbias


def flash_bwd_dbias_fp32(q, k, v, do, lse, delta, bias, *, causal: bool,
                         softcap: float, masks: KernelMasks = None):
    """The fp32 dbias kernel (csrc/flash_fp32.cu
    flash_bwd_dbias_fp32_kernel): :func:`flash_bwd_dbias` for float32 q_s,
    k, v and do (q_s the pre-pass's fp32 q * sm_scale; every product as
    three TF32 products), an fp32 or bf16 bias, dbias in its dtype.
    ``flash_bwd_dbias_fp32.launches`` counts its launches."""
    dbias = _launch_dbias("xfa_flash_bwd_dbias_fp32", q, k, v, do, lse, delta,
                          bias, causal, softcap, masks, F32, "dq_fp32")
    flash_bwd_dbias_fp32.launches += 1
    return dbias


def _launch_dbias(entry, q, k, v, do, lse, delta, bias, causal, softcap,
                  masks, dtype, kind):
    """One launch of the dbias C entry ``entry`` on q_s, k, v, do of
    ``dtype``, the mask arguments at kernel ``kind``'s tiles (the kernels
    read the window, segment ids and positions only); the zero-filled
    dbias buffer the kernel writes, as its (bb, bh, sq, sk) view."""
    _cuda.require_cuda(q, k, v, do, lse, delta, bias,
                       *(masks.tensors() if masks is not None else ()))
    _check_shapes(q, k, v, do, lse, q, k, v, dtype)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    bias, bias_args = kernel_bias(bias, masks, b, h, sq, sk)
    bb, bh = bias.shape[:2]
    dbias = torch.zeros(bb, bh, sq, sk + sk % 2, dtype=bias.dtype,
                        device=q.device)
    if min(sq, sk) == 0:
        return dbias[..., :sk]
    code = getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dbias.data_ptr(),
        *(s for t in (q, k, v, do, dbias) for s in t.stride()[:3]),
        b, h, hk, sq, sk, d, bb, bh, float(softcap), int(causal),
        *KernelMasks.c_args(masks, causal, kind, d), *bias_args,
        _cuda.stream())
    _cuda.check(code, entry[4:])
    return dbias[..., :sk]


flash_bwd_dbias.launches = 0
flash_bwd_dbias_fp32.launches = 0


def bwd_prep_ref(q, out, do, *, sm_scale: float, scale_q: bool = True):
    """Plain version of the pre-pass: (q_s, delta), q_s = q * sm_scale in
    fp32 rounded to q's dtype, (b, h, sq, d) contiguous (None without
    ``scale_q``), and delta = rowsum(dO * O) in fp32, (b, h, sq)
    contiguous."""
    qs = ((q.float() * sm_scale).to(q.dtype).contiguous() if scale_q
          else None)
    return qs, (do.float() * out.float()).sum(-1).contiguous()


def flash_bwd_prep(q, out, do, *, sm_scale: float, scale_q: bool = True):
    """The pre-pass kernel of the backward on (b, h, sq, d) bf16 or fp32
    views of any strides (head dim contiguous, 16-byte aligned rows):
    returns (q_s, delta) as :func:`bwd_prep_ref` does (q_s in q's dtype).
    ``flash_bwd_prep.launches`` counts its launches, of either dtype."""
    if q.device.type == "cpu":
        return bwd_prep_ref(q, out, do, sm_scale=sm_scale, scale_q=scale_q)
    _cuda.require_cuda(q, out, do)
    b, h, sq, d = q.shape
    if q.dtype not in (torch.bfloat16, F32) or any(
            t.dtype != q.dtype for t in (out, do)):
        raise NotImplementedError(CUDA_DTYPE_NOT_PORTED)
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernels take 64 or 128")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} out {tuple(out.shape)} "
                         f"do {tuple(do.shape)}")
    for t, name in ((q, "q"), (out, "out"), (do, "do")):
        _cuda.require_aligned(t, 16 // t.element_size(), name)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    qs = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device) \
        if scale_q else None
    code = _cuda.lib().xfa_flash_bwd_prep(
        q.data_ptr(), do.data_ptr(), out.data_ptr(), _cuda.ptr(qs),
        delta.data_ptr(), *q.stride()[:3], *do.stride()[:3],
        *out.stride()[:3], b, h, sq, d, float(sm_scale), _cuda.dtype_code(q),
        _cuda.stream())
    _cuda.check(code, "flash_bwd_prep")
    flash_bwd_prep.launches += 1
    return qs, delta


flash_bwd_prep.launches = 0


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


def flash_bwd_dkv_fp32(q, k, v, do, lse, delta, dq, dk, dv, **kw) -> None:
    """The fp32 dK/dV kernel (TPU kernel #2 in fp32);
    ``flash_bwd_dkv_fp32.launches`` counts its launches."""
    launch_flash_bwd_fp32("dkv", q, k, v, do, lse, delta, dq, dk, dv, **kw)
    flash_bwd_dkv_fp32.launches += 1


def flash_bwd_dq_fp32(q, k, v, do, lse, delta, dq, dk, dv, **kw) -> None:
    """The fp32 dQ kernel (TPU kernel #3 in fp32);
    ``flash_bwd_dq_fp32.launches`` counts its launches."""
    launch_flash_bwd_fp32("dq", q, k, v, do, lse, delta, dq, dk, dv, **kw)
    flash_bwd_dq_fp32.launches += 1


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv_fp32.launches = 0
flash_bwd_dq_fp32.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, bias=None, q_segment_ids=None,
                        kv_segment_ids=None, *, sm_scale: float,
                        causal: bool = False,
                        window_size: Tuple[int, int] = (-1, -1),
                        softcap: float = 0.0, dropout_p: float = 0.0,
                        dropout_seed=None,
                        flashmask_vecs=None, flashmask_mode=None,
                        block_mask=None, q_positions=None, kv_positions=None,
                        masks: KernelMasks = None, need_dqkv: bool = True,
                        need_dbias: bool = True):
    """Backward attention on (batch, heads, seq, head_dim) tensors.

    Returns (dq, dk, dv) with dk/dv reduced over the GQA group (the shape of
    k/v), and with a ``bias`` (the forward's) (dq, dk, dv, dbias), dbias in
    the bias's shape and dtype, summed over the axes it broadcasts (as the
    TPU package's bwd.py:1302-1312). On CUDA the gradients are allocated in
    (b, s, h, d) memory order and returned as (b, h, s, d) views, like the
    forward's output. The mask flags are the forward's (fwd.py
    `flash_attention_fwd`), or ``masks`` as :func:`fwd.build_masks` made
    them (then ``causal`` must be the flag it returned). ``need_dqkv`` and
    ``need_dbias`` False leave (dq, dk, dv) or dbias None, and their
    kernels unlaunched. ``dropout_p`` and ``dropout_seed`` are the
    forward's (fwd.py `flash_attention_fwd`); the backward regenerates its
    keep mask.
    """
    check_supported(q, bias, dropout_p, "flash_attention_bwd")
    drop = Dropout.make(dropout_p, dropout_seed)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    bias4 = None if bias is None else bias_view(bias, b, h, sq, sk)
    if masks is None:
        causal, masks = build_masks(
            b, h, sq, sk, causal, window_size, flashmask_vecs=flashmask_vecs,
            flashmask_mode=flashmask_mode, block_mask=block_mask,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions)
    if q.device.type == "cpu":
        grads = attention_bwd_ref(q, k, v, out, lse, do, sm_scale=sm_scale,
                                  causal=causal, softcap=softcap,
                                  mask=masks.keep(h), bias=bias4,
                                  dropout=drop)
        if not need_dqkv:
            grads = (None,) * 3 + grads[3:]
        if bias is None:
            return grads
        return grads[:3] + (grads[3].reshape(bias.shape)
                            if need_dbias else None,)

    def grad_like(n, s):
        return torch.empty(b, s, n, d, dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    # TMA reads 16-byte aligned bases and strides; autograd may hand over
    # expanded or transposed tensors
    q, k, v, out, do = (_cuda.aligned(t, 8) for t in (q, k, v, out, do))
    qs, delta = flash_bwd_prep(q, out, do, sm_scale=sm_scale)
    dq = dk = dv = None
    if need_dqkv:
        dq, dk, dv = grad_like(h, sq), grad_like(hk, sk), grad_like(hk, sk)
        args = (qs, k, v, do, lse, delta, dq, dk, dv)
        if q.dtype == F32:
            kw = dict(sm_scale=sm_scale, window=fp32_window(masks, causal),
                      softcap=softcap, masks=masks, causal=causal,
                      bias=bias4)
            flash_bwd_dkv_fp32(*args, **kw)
            flash_bwd_dq_fp32(*args, **kw)
        else:
            kw = dict(sm_scale=sm_scale, causal=causal, softcap=softcap,
                      masks=masks, bias=bias4, dropout=drop)
            flash_bwd_dkv(*args, **kw)
            flash_bwd_dq(*args, **kw)
    if bias is None:
        return dq, dk, dv
    dbias = None
    if need_dbias:
        dbias = flash_bwd_dbias(qs, k, v, do, lse, delta, bias4,
                                causal=causal, softcap=softcap,
                                masks=masks).reshape(bias.shape)
    return dq, dk, dv, dbias
