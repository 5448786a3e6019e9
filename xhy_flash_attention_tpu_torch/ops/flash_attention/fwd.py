"""FlashAttention-2 forward (≙ xhy_flash_attention_tpu
ops/flash_attention/fwd.py `flash_attention_fwd`).

On a CUDA tensor the work runs in csrc/flash_fwd.cu, the counterpart of the
TPU kernel `_fwd_kernel` (fwd.py:78); on a CPU tensor in its plain version
:func:`attention_fwd_ref`. The kernel is one Hopper kernel (TMA ring,
wgmma, a producer warpgroup) in two instantiations. Without a sparse mask
:func:`fwd_tile_plan` mirrors the key tiles it visits and
:func:`fwd_schedule` the blocks each of its persistent CTAs runs; with a
FlashMask or block mask its producer decides from the mask which tiles each
block visits (:func:`fwd_masked_tile_plan`) and the blocks come from a
counter on the card. Covered: causal and full attention, GQA, softcap,
the LSE output, FlashMask (column-wise row bands, four modes, mask heads
dividing the query heads), block-sparse masks (a 0/1 mask at a granularity
of a multiple of 64), sliding windows, segment ids and q/kv positions (the
masked instantiation: the producer walks the window's key tiles, within
the range of tiles the segment and position stats allow), and an additive
attention bias (bb, bh, sq, sk) in fp32 or bf16, broadcast over batches or
heads by strides (:func:`bias_view`, :func:`bias_c_args`), with any flag
but FlashMask and block masks (the bias instantiations, which read it in
each thread's accumulator layout under the scores' product); the backward
is bwd.py, joined to this forward by interface.py's autograd function.
FP8 e4m3 q/k/v with (b, hk) descales (:func:`flash_fwd_fp8`, forward only,
as in the TPU package) run the kernel's e4m3 instantiation, with causal,
windows, softcap, GQA and the LSE; it takes no bias, mask, segment ids or
dropout. float32 q/k/v on the card run csrc/flash_fp32.cu (three TF32
products on the tensor cores for each fp32 product, fed by TMA rings;
:func:`flash_fwd_fp32`, and through :func:`launch_flash_fwd` the packed
layout) with causal, windows, softcap, GQA and the LSE, under a
FlashMask, block mask, segment ids or positions its masked instantiation
(the producer decides the tiles as the bf16 masked kernel's does, at the
fp32 kernel's key tiles: :func:`fwd_masked_tile_plan` with ``fp32``),
and with an fp32 or bf16 bias its bias instantiation (dense or masked;
not with a FlashMask or block mask), which reads the bias as the bf16
kernel does. Attention dropout (a :class:`common.Dropout`) runs the bf16
kernel's dropout instantiations (dense or masked, no bias), which hash
each element of P in the accumulators (:func:`common.dropout_keep_mask`);
in float32 or beside a bias it raises NotImplementedError on the card
(:func:`check_supported`), as fp16 does (:data:`common.SLICE_DTYPES`).
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import torch

from .. import _cuda
from .common import (CUDA_DTYPE_NOT_PORTED, SLICE_DROPOUT, Dropout,
                     KernelMasks, cdiv, expand_heads, fm_skip_bypass,
                     kernel_tiles, resolve_window)
from .reference import attention_fp8_ref

__all__ = ["attention_fwd_ref", "bias_c_args", "bias_view", "build_masks",
           "flash_attention_fwd", "flash_fwd_fp32", "flash_fwd_fp8",
           "fp32_window", "fwd_masked_tile_plan", "fwd_schedule",
           "fwd_tile_plan", "kernel_bias", "key_window_plan",
           "launch_flash_fwd_fp32",
           "masked_row_block_plan"]

FP8 = torch.float8_e4m3fn
F32 = torch.float32

# Tiles of the dense (unmasked) kernel, csrc/flash_fwd.cu kTileM / kTileN:
# query rows per block and keys per tile.
FWD_DENSE_TILE_M = 128
FWD_DENSE_TILE_N = 128
# Under a mask each consumer of a masked kernel computes a part of 64 rows
# (the forward, dQ) or 64 keys (dK/dV) of its block against the 64-key parts
# of a tile, each part inside one block-mask entry.
MASK_PART = 64


def key_window_plan(sq: int, sk: int, m: int, n: int, window=(-1, -1)):
    """The key tiles of ``n`` keys that a kernel considers for each block of
    ``m`` query rows under a row/key window (left, right), bottom-right
    aligned, -1 no bound (csrc/common.cuh `key_window`, and `key_tiles`
    for causal, right 0): for each block, a list of (tile index, masked)
    in visit order, last tile first. Tile t holds keys [t * n, (t + 1) *
    n); ``masked`` tiles run the elementwise window / sk test, the others
    none (rows past sq are not written, so they do not count)."""
    left, right = window
    off, plan = sk - sq, []
    for q0 in range(0, sq, m):
        r0, r1 = q0, min(q0 + m, sq) - 1
        kmax = sk - 1 if right < 0 else min(sk - 1, r1 + off + right)
        kmin = 0 if left < 0 else max(0, r0 + off - left)
        if kmax < kmin:
            plan.append([])
            continue
        lo, hi = kmin // n, kmax // n + 1
        fmax = sk if right < 0 else min(sk, r0 + off + right + 1)
        fmin = 0 if left < 0 else max(0, r1 + off - left)
        f_lo, f_hi = max(lo, cdiv(fmin, n)), min(hi, max(fmax, 0) // n)
        plan.append([(t, not f_lo <= t < f_hi)
                     for t in reversed(range(lo, hi))])
    return plan


def key_tile_plan(sq: int, sk: int, causal: bool, m: int, n: int):
    """:func:`key_window_plan` of the dense kernels: causal (right bound
    0) or no window."""
    return key_window_plan(sq, sk, m, n, (-1, 0 if causal else -1))


def pair_schedule(n_blocks: int, heads: int, b: int, ctas: int,
                  heavy_last: bool):
    """A persistent kernel's schedule (csrc/common.cuh `block_pairs`,
    `pair_block`): for each of ``ctas`` CTAs, the (batch, head, block) it
    runs, in order. Pair j of a (batch, head) is the heavier block, then
    its partner: block n_blocks - 1 - j, then block j with ``heavy_last``
    (query blocks), else the other way round (key blocks); the middle
    block of an odd count alone. CTA c takes pairs c, c + ctas, ...; the
    kernels launch min(pairs, SMs) CTAs."""
    per_head = (n_blocks + 1) // 2
    out = [[] for _ in range(ctas)]
    for c in range(ctas):
        for pair in range(c, per_head * heads * b, ctas):
            j, bh = pair % per_head, pair // per_head
            head, batch = bh % heads, bh // heads
            heavy = n_blocks - 1 - j if heavy_last else j
            out[c].append((batch, head, heavy))
            if j != n_blocks - 1 - j:
                out[c].append((batch, head, n_blocks - 1 - heavy))
    return out


def fwd_tile_plan(sq: int, sk: int, causal: bool):
    """The key tiles the dense kernel visits (csrc/flash_fwd.cu): for each
    block of FWD_DENSE_TILE_M query rows, a list of (tile index, masked) of
    FWD_DENSE_TILE_N keys, in visit order (:func:`key_tile_plan`)."""
    return key_tile_plan(sq, sk, causal, FWD_DENSE_TILE_M, FWD_DENSE_TILE_N)


def fwd_schedule(sq: int, h: int, b: int, ctas: int):
    """The dense kernel's persistent schedule: for each of ``ctas`` CTAs,
    the (batch, head, query block) it runs, in order, the heavier block of
    each pair first (:func:`pair_schedule`)."""
    return pair_schedule(cdiv(sq, FWD_DENSE_TILE_M), h, b, ctas, True)


def masked_window(masks: KernelMasks, causal: bool):
    """The row/key window the masked kernels apply: the flags' window with
    the right bound 0 under ``causal`` (KernelMasks.c_args)."""
    left, right = masks.window
    return left, 0 if causal else right


def token_flags(qs, ks, pos_window):
    """The segment / position decision of a query tile with stats ``qs``
    against a key tile with ``ks`` ([segment min, max, position min, max]):
    -1 skipped, 0 bypassed, 1 the elementwise test (csrc/common.cuh
    ``token_flags``)."""
    skip = qs[0] > ks[1] or ks[0] > qs[1]
    bypass = qs[0] == qs[1] == ks[0] == ks[1]
    left, right = pos_window
    if right >= 0:
        skip |= ks[2] > qs[3] + right
        bypass &= ks[3] <= qs[2] + right
    if left >= 0:
        skip |= ks[3] < qs[2] - left
        bypass &= ks[2] >= qs[3] - left
    return -1 if skip else (0 if bypass else 1)


class MaskTiles:
    """The masked kernels' producer's view of a :class:`KernelMasks` for
    key tiles of ``tile_keys`` keys and query tiles of ``tile_rows`` rows
    (csrc/common.cuh ``fm_decide``, ``bm_on``, ``token_flags``), on Python
    ints; ``kind`` names the kernel whose tile ranges it reads."""

    def __init__(self, masks: KernelMasks, h: int, tile_keys: int,
                 tile_rows: int = 128, kind: str = "fwd", d: int = 64):
        self.h, self.tile, self.rows = h, tile_keys, tile_rows
        self.fm = self.bm = self.tok = None
        if masks.fm_vecs is not None:
            self.mode = masks.fm_mode
            self.fm = masks.stats(tile_keys).cpu().tolist()
        if masks.bm is not None:
            self.bm, self.gq, self.gk = masks.bm.cpu().tolist(), masks.gq, \
                masks.gk
        if masks.has_tokens:
            self.tok = (masks.tok_stats(0, tile_rows).cpu().tolist(),
                        masks.tok_stats(1, tile_keys).cpu().tolist())
            self.rng = masks.ranges(kind, d).cpu().tolist()
            self.pos_window = masks.pos_window

    def decide(self, batch: int, head: int, q0: int, q1: int, col0: int):
        """(skip, bypass) of rows [q0, q1) against the tile at col0 by the
        FlashMask stats."""
        if self.fm is None:
            return False, True
        per_batch = self.fm[batch]
        st = per_batch[head // (self.h // len(per_batch))][col0 // self.tile]
        return fm_skip_bypass(self.mode, lambda v, w: st[v][w], q0, q1)

    def tokens(self, batch: int, q0: int, col0: int) -> int:
        """The segment / position decision of the query tile at q0 against
        the key tile at col0 (:func:`token_flags`; 0 without them)."""
        if self.tok is None:
            return 0
        return token_flags(self.tok[0][batch][q0 // self.rows],
                           self.tok[1][batch][col0 // self.tile],
                           self.pos_window)

    def range(self, batch: int, block: int):
        """Block ``block``'s tile range [lo, hi) from the segment and
        position stats, or None without them."""
        return None if self.tok is None else self.rng[batch][block]

    def on(self, batch: int, head: int, row: int, col: int) -> bool:
        """The block-mask entry of (row, col) (True without a block
        mask)."""
        if self.bm is None:
            return True
        per_batch = self.bm[batch if len(self.bm) > 1 else 0]
        entry = per_batch[head // (self.h // len(per_batch))]
        return entry[row // self.gq][col // self.gk] != 0


def cut_to_range(lo: int, hi: int, rng):
    """Candidate tiles [lo, hi) cut to a block's tile range ``rng`` (None:
    unchanged), as csrc/common.cuh key_window and query_window cut them."""
    if rng is None:
        return lo, hi
    lo = max(lo, rng[0])
    return lo, max(lo, min(hi, rng[1]))


def elementwise_first(tiles, flag):
    """Tiles with the elementwise test (``tile[flag]``) first, then the
    others, each in their order (common.cuh ``emit_tiles``)."""
    return [t for t in tiles if t[flag]] + [t for t in tiles if not t[flag]]


def masked_row_block_plan(masks: KernelMasks, b: int, h: int, sq: int,
                          sk: int, causal: bool, n: int, kind: str = "fwd",
                          d: int = 64):
    """The key tiles a masked kernel with blocks of 128 query rows visits
    over key tiles of ``n`` keys (csrc/common.cuh ``row_block_tile_flags``
    and the producer of flash_fwd.cu and of flash_bwd.cu's dQ kernel): for
    each block (batch, head, query block), a list of (tile, elementwise,
    parts) in visit order, ``parts[c][j]`` whether consumer c (rows [64c,
    64c + 64) of the block) computes the tile's keys [64j, 64j + 64) (both
    the same for a tile of 64 keys): on when those rows and keys start
    below sq and sk and their block-mask entry is on. The candidates are
    :func:`key_window_plan`'s under the masked window, cut to the block's
    range of tiles from the segment and position stats (``kind``'s); a
    tile is skipped when the FlashMask stats (per tile of ``n`` keys) or
    the segment / position stats mask the block's rows everywhere or no
    part is on. ``elementwise``: the plan's window / ragged test, the
    FlashMask band test, the segment / position test, or a consumer whose
    two key parts differ; those come first."""
    m = FWD_DENSE_TILE_M
    mt = MaskTiles(masks, h, n, m, kind, d)
    plan = {}
    for mb, cands in enumerate(key_window_plan(sq, sk, m, n,
                                               masked_window(masks, causal))):
        q0 = mb * m
        free = {t for t, masked in cands if not masked}
        hi = cands[0][0] + 1 if cands else 0
        lo = cands[-1][0] if cands else 0
        for batch in range(b):
            c_lo, c_hi = cut_to_range(lo, hi, mt.range(batch, mb))
            for head in range(h):
                found = []
                for t in reversed(range(c_lo, c_hi)):
                    n0 = t * n
                    skip, bypass = mt.decide(batch, head, q0, min(q0 + m, sq),
                                             n0)
                    tok = mt.tokens(batch, q0, n0)
                    keys = (n0, n0 + MASK_PART if n == 2 * MASK_PART else n0)
                    parts = tuple(
                        tuple(row < sq and key < sk
                              and mt.on(batch, head, row, key) for key in keys)
                        for row in (q0, q0 + MASK_PART))
                    if skip or tok < 0 or not any(map(any, parts)):
                        continue
                    straddle = any(a != c for a, c in parts)
                    found.append((t, t not in free or not bypass or tok > 0
                                  or straddle, parts))
                plan[(batch, head, mb)] = elementwise_first(found, 1)
    return plan


def fwd_masked_tile_plan(masks: KernelMasks, b: int, h: int, sq: int,
                         sk: int, causal: bool, d: int = 64,
                         fp32: bool = False):
    """The key tiles the masked forward kernel visits: for each block
    (batch, head, query block of FWD_DENSE_TILE_M rows), (tile,
    elementwise, parts) of FWD_DENSE_TILE_N keys in visit order
    (:func:`masked_row_block_plan`); with ``fp32`` those of the fp32
    kernel at head dim ``d`` (csrc/flash_fp32.cu, its key tiles
    :func:`common.kernel_tiles` "fwd_fp32")."""
    if not fp32:
        return masked_row_block_plan(masks, b, h, sq, sk, causal,
                                     FWD_DENSE_TILE_N)
    return masked_row_block_plan(masks, b, h, sq, sk, causal,
                                 kernel_tiles("fwd_fp32", d)[1], "fwd_fp32",
                                 d)


def bias_view(bias: torch.Tensor, b: int, h: int, sq: int,
              sk: int) -> torch.Tensor:
    """The attention bias as a (bb, bh, sq, sk) view, the shapes the TPU
    package takes (its fwd.py:853-861): (sq, sk) -> (1, 1, sq, sk); (bb,
    sq, sk) -> (bb, 1, sq, sk); (bb, bh, sq, sk) as it is; bb in {1, b}, bh
    in {1, h}, the query heads. fp32 or bf16. ``ValueError`` otherwise."""
    if bias.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention bias must be float32 or bfloat16, got "
                         f"{bias.dtype}")
    shape = tuple(bias.shape)
    if bias.dim() == 2:
        bias = bias[None, None]
    elif bias.dim() == 3:
        bias = bias[:, None]
    if (bias.dim() != 4 or tuple(bias.shape[2:]) != (sq, sk)
            or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)):
        raise ValueError(
            f"attention bias of shape {shape} does not broadcast as (1|{b}, "
            f"1|{h}, {sq}, {sk}), ({sq}, {sk}) or (1|{b}, {sq}, {sk})")
    return bias


def bias_c_args(bias: torch.Tensor) -> tuple:
    """(tensor, C arguments) of a (bb, bh, sq, sk) bias for the kernels'
    XFA_BIAS_ARGS (csrc/common.cuh BiasParams): pointer, batch, head and
    row strides (0 on a broadcast axis) and the dtype code. The kernels read
    a key pair in one load, so the keys must be contiguous and the pointer
    and strides even; else the bias is copied once into a contiguous tensor
    whose rows are padded to an even length (the padding zero and never
    used). The tensor returned keeps the memory alive."""
    bb, bh, sq, sk = bias.shape
    sb = bias.stride(0) if bb > 1 else 0
    sh = bias.stride(1) if bh > 1 else 0
    ss = bias.stride(2) if sq > 1 else 0
    if (bias.stride(3) != 1 and sk > 1) or any(x % 2 for x in (sb, sh, ss)) \
            or bias.data_ptr() % (2 * bias.element_size()):
        pad = torch.zeros(bb, bh, sq, sk + sk % 2, dtype=bias.dtype,
                          device=bias.device)
        pad[..., :sk].copy_(bias)
        bias = pad
        sb, sh, ss = (bias.stride(i) if bias.shape[i] > 1 else 0
                      for i in range(3))
    return bias, (bias.data_ptr(), sb, sh, ss, _cuda.dtype_code(bias))


NO_BIAS = (None, 0, 0, 0, 0)  # XFA_BIAS_ARGS without a bias


def attention_fwd_ref(q, k, v, *, sm_scale: float, causal: bool,
                      softcap: float, need_lse: bool, mask=None, bias=None,
                      dropout: Optional[Dropout] = None):
    """Plain version of the kernel on (b, h, s, d) tensors of any strides.

    The same arithmetic as the kernel and the TPU kernels: q scaled in fp32
    and rounded to its dtype, fp32 scores, softcap, the optional bias (bb,
    bh, sq, sk) in fp32 (:func:`bias_view`), bottom-right causal mask, the
    optional dense keep mask ``mask`` (b|1, hm|1, sq, sk), True = attend,
    head i reading mask head i // (h / hm), fp32 softmax with P rounded to
    v's dtype for P.V, division by the fp32 row sum. With ``dropout``
    (:class:`common.Dropout`) the row sum and the LSE are the undropped
    P's, the dropped elements of P are 0 in P.V, and the output is scaled
    by 1 / (1 - p) with the division, as the kernel's epilogue does.
    Returns (out (b, h, sq, d), lse (b, h, sq) fp32 | None); rows that see
    no key give 0 and lse +inf.
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
    if bias is not None:
        s = s + bias.float()
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), -math.inf)
    if mask is not None:
        s = s.masked_fill(~expand_heads(mask, h), -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout is not None:
        p = p.masked_fill(~dropout.keep(b, h, sq, sk, q.device), 0.0)
    o = p.to(v.dtype).float() @ vf
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    if dropout is not None:
        o = o * dropout.scale
    lse = None
    if need_lse:
        lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return o.to(q.dtype), lse


def launch_flash_fwd(q, k, v, out, lse, *, sm_scale: float, causal: bool,
                     softcap: float, masks: KernelMasks = None,
                     tile_counts=None, bias=None,
                     dropout: Optional[Dropout] = None) -> None:
    """Launch csrc/flash_fwd.cu on (b, h, s, d)-shaped views of any strides
    (head dim contiguous): q, out (b, h, sq, d); k, v (b, hk, sk, d); lse
    (b, h, sq) fp32 contiguous or None; ``masks`` the FlashMask and block
    mask flags, or None. The kernel reads and writes through TMA tensor
    maps, so pointers and strides must be multiples of 16 bytes (8
    elements): ``ValueError`` otherwise. A mask runs the masked
    instantiation, whose blocks come from a counter in device memory (the
    heavier first); its three int32 counters are written to
    ``tile_counts`` when it is given (a contiguous int32 tensor of 3 on the
    card): the scheduler's, then the tiles the kernel visited and those of
    them with the elementwise test, as :func:`fwd_masked_tile_plan` counts
    them. ``bias``: a (bb, bh, sq, sk) fp32 or bf16 bias (:func:`bias_view`)
    or None; it runs the bias instantiation, and takes no FlashMask or
    block mask. ``dropout``: a :class:`common.Dropout` or None; it runs
    the dropout instantiations (bf16, no bias), which hash each element of
    P in the accumulators and fold 1 / (1 - p) into the epilogue;
    ``launch_flash_fwd.dropout_launches`` counts their launches by
    instantiation (:func:`dropout_instance`). float32
    tensors go to :func:`launch_flash_fwd_fp32` (``tile_counts`` as
    :func:`fwd_masked_tile_plan` with ``fp32`` counts them; ``bias`` as
    here). The callers count the launch."""
    if dropout is not None:
        check_supported(q, bias, dropout.p, "flash_fwd")
    if q.dtype == F32:
        launch_flash_fwd_fp32(q, k, v, out, lse, sm_scale=sm_scale,
                              window=fp32_window(masks, causal),
                              softcap=softcap, masks=masks, causal=causal,
                              tile_counts=tile_counts, bias=bias)
        return
    tensors = [t for t in (q, k, v, out, lse, bias) if t is not None]
    if masks is not None:
        tensors += masks.tensors()
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
    check_tile_counts(tile_counts, q.device)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _cuda.require_aligned(t, 8, name)
    masked = masks is not None and masks.active
    bias, bias_args = kernel_bias(bias, masks, b, h, sq, sk)
    counters = masked_counters(masks, tile_counts, q.device)
    code = _cuda.lib().xfa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _cuda.ptr(lse),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, hk, sq, sk, d, float(sm_scale), float(softcap), int(causal),
        *KernelMasks.c_args(masks, causal, "fwd", d),
        _cuda.ptr(masks.bands() if masked else None), _cuda.ptr(counters),
        *bias_args, *Dropout.c_args(dropout), _cuda.stream())
    _cuda.check(code, "flash_fwd")
    if dropout is not None:
        launch_flash_fwd.dropout_launches[dropout_instance(d, masked)] += 1


launch_flash_fwd.dropout_launches = collections.Counter()


def dropout_instance(d: int, masked: bool) -> str:
    """The name of a dropout instantiation in the launch counts: its head
    dim, and whether it is the masked one ("d64", "d128 masked")."""
    return f"d{d} masked" if masked else f"d{d}"


def check_tile_counts(tile_counts, device) -> None:
    """``ValueError`` unless ``tile_counts`` is None or a contiguous int32
    tensor of 3 on ``device``."""
    if tile_counts is not None and (
            tile_counts.shape != (3,) or tile_counts.dtype != torch.int32
            or tile_counts.device != device
            or not tile_counts.is_contiguous()):
        raise ValueError("tile_counts must be a contiguous int32 tensor of "
                         "3 on q's device")


def masked_counters(masks: Optional[KernelMasks], tile_counts, device,
                    fp32: bool = False):
    """The masked kernels' three int32 counters (``tile_counts`` when
    given), or None when the dense kernel runs: without flags, and for the
    fp32 kernels also with a window alone (their dense instantiation takes
    it)."""
    if masks is None or not (masks.tensors() if fp32 else masks.active):
        return None
    return (tile_counts if tile_counts is not None else
            torch.empty(3, dtype=torch.int32, device=device))


def kernel_bias(bias, masks: Optional[KernelMasks], b: int, h: int, sq: int,
                sk: int):
    """(bias, XFA_BIAS_ARGS) of a kernel's bias argument: :data:`NO_BIAS`
    without one; else the (bb, bh, sq, sk) view (:func:`bias_view`) as
    :func:`bias_c_args` hands it over. ``ValueError`` for a bias beside a
    FlashMask or block mask, which the TPU package refuses too."""
    if bias is None:
        return None, NO_BIAS
    bias = bias_view(bias, b, h, sq, sk)
    if masks is not None and (masks.fm_vecs is not None
                              or masks.bm is not None):
        raise ValueError("an attention bias takes no FlashMask or block "
                         "mask, as in the TPU package")
    return bias_c_args(bias)


def fp32_window(masks: Optional[KernelMasks], causal: bool):
    """The (left, right) window of the fp32 kernels (-1 no bound, causal
    right 0) for the flags ``masks`` carries: a FlashMask, block mask,
    segment ids and positions run their masked instantiations."""
    if masks is None:
        return -1, 0 if causal else -1
    return masked_window(masks, causal)


def launch_flash_fwd_fp32(q, k, v, out, lse, *, sm_scale: float, window,
                          softcap: float, paged=None, masks=None,
                          causal: bool = False, tile_counts=None,
                          bias=None) -> None:
    """Launch csrc/flash_fp32.cu's forward on (b, h, s, d) float32 views of
    any strides (head dim contiguous; pointers and strides multiples of 16
    bytes, 4 elements: ``ValueError`` otherwise): q, out (b, h, sq, d); k,
    v (b, hk, sk, d); lse (b, h, sq) fp32 contiguous or None; ``window``
    (left, right), -1 no bound, causal as right 0 (:func:`fp32_window`).
    ``paged``: (kv_pages (P, hk, 2, ps, d) fp32 contiguous, page_table (b,
    npp) int32, lengths (b,) int32) in place of k and v (None): each
    sequence's keys through its page table, its rows the last sq of its
    lengths[b] keys (the prefill regime of inference/paged.py on fp32
    pages). ``masks``: the flags (and ``causal``, the plain flag
    fwd.build_masks returned); a FlashMask, block mask, segment ids or
    positions run the masked instantiation, whose three int32 counters are
    written to ``tile_counts`` when it is given (as :func:`launch_flash_fwd`
    does). ``bias``: a (bb, bh, sq, sk) fp32 or bf16 bias
    (:func:`bias_view`) or None; it runs the bias instantiation (dense or
    masked), and takes no page table, FlashMask or block mask. The callers
    count the launch."""
    b, h, sq, d = q.shape
    table = lengths = None
    ps = npp = num_pages = 0
    if paged is not None:
        pages, table, lengths = paged
        num_pages, hk, _, ps, _ = pages.shape
        npp = table.shape[1]
        k = v = pages
        sk, kstr, vstr = npp * ps, (0, 0, 0), (0, 0, 0)
        if not pages.is_contiguous() or pages.shape[4] != d:
            raise ValueError("kv_pages must be contiguous (P, hk, 2, ps, d)")
        for t, name in ((table, "page_table"), (lengths, "lengths")):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous int32")
    else:
        hk, sk = k.shape[1], k.shape[2]
        kstr, vstr = k.stride()[:3], v.stride()[:3]
        if v.shape != k.shape or k.shape[3] != d:
            raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                             f"v {tuple(v.shape)}")
    _cuda.require_cuda(*(t for t in (q, k, v, out, lse, table, lengths,
                                     bias) if t is not None))
    if paged is not None and bias is not None:
        raise ValueError("the paged fp32 forward takes no attention bias")
    if any(t.dtype != F32 for t in (q, k, v, out)):
        raise NotImplementedError(CUDA_DTYPE_NOT_PORTED)
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if h % hk or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} out {tuple(out.shape)}, "
                         f"{hk} kv heads")
    if lse is not None and (lse.shape != (b, h, sq) or not lse.is_contiguous()
                            or lse.dtype != F32):
        raise ValueError("lse must be a contiguous fp32 (b, h, sq) tensor")
    for t, name in ((q, "q"), (out, "out"), (k, "k"), (v, "v")):
        _cuda.require_aligned(t, 4, name)
    check_tile_counts(tile_counts, q.device)
    bias, bias_args = kernel_bias(bias, masks, b, h, sq, sk)
    counters = masked_counters(masks, tile_counts, q.device, fp32=True)
    if counters is not None:
        _cuda.require_cuda(*masks.tensors())
    code = _cuda.lib().xfa_flash_fwd_fp32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _cuda.ptr(lse), *q.stride()[:3], *kstr, *vstr, *out.stride()[:3],
        b, h, hk, sq, sk, d, float(sm_scale), float(softcap),
        int(window[0]), int(window[1]), _cuda.ptr(table), _cuda.ptr(lengths),
        ps, npp, num_pages,
        *KernelMasks.c_args(masks if counters is not None else None, causal,
                            "fwd_fp32", d),
        _cuda.ptr(masks.bands() if counters is not None else None),
        _cuda.ptr(counters), *bias_args, _cuda.stream())
    _cuda.check(code, "flash_fwd_fp32")


def flash_fwd_fp32(q, k, v, *, sm_scale: float, window=(-1, -1),
                   softcap: float = 0.0, need_lse: bool = True, masks=None,
                   causal: bool = False, bias=None):
    """The fp32 forward (csrc/flash_fp32.cu) on (b, h, s, d) float32 views
    on the card: q (b, h, sq, d), k/v (b, hk, sk, d); ``window`` (left,
    right) as :func:`fp32_window` gives it; ``masks`` and ``causal`` as
    :func:`build_masks` made them (the masked instantiation under a
    FlashMask, block mask, segment ids or positions); ``bias`` a (bb, bh,
    sq, sk) fp32 or bf16 bias or None (the bias instantiation). Returns
    (out (b, h, sq, d) fp32, allocated in (b, sq, h, d) memory order as
    :func:`flash_attention_fwd` does, lse (b, h, sq) fp32 | None).

    ``flash_fwd_fp32.launches`` counts kernel launches."""
    b, h, sq, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=F32, device=q.device).transpose(1, 2)
    lse = (torch.empty(b, h, sq, dtype=F32, device=q.device)
           if need_lse else None)
    launch_flash_fwd_fp32(q, k, v, out, lse, sm_scale=sm_scale, window=window,
                          softcap=softcap, masks=masks, causal=causal,
                          bias=bias)
    flash_fwd_fp32.launches += 1
    return out, lse


flash_fwd_fp32.launches = 0


def fp8_descale_arg(x, b: int, hk: int, device):
    """A (b, hk) descale as a contiguous fp32 tensor on ``device``, or None
    (the kernel reads ones)."""
    if x is None:
        return None
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.numel() != b * hk:
        raise ValueError(f"a descale must be ({b}, {hk}), got "
                         f"{tuple(x.shape)}")
    return x.reshape(b, hk).contiguous()


def launch_flash_fwd_fp8(q, k, v, out, lse, descales, *, sm_scale: float,
                         window, softcap: float) -> None:
    """Launch the e4m3 instantiation of csrc/flash_fwd.cu on (b, h, s, d)
    views of any strides (head dim contiguous): q (b, h, sq, d), k, v (b,
    hk, sk, d) float8_e4m3fn, out (b, h, sq, d) bf16, lse (b, h, sq) fp32
    contiguous or None; ``descales`` (q, k, v), each a contiguous (b, hk)
    fp32 tensor on the card or None (ones); ``window`` (left, right), -1
    no bound, causal as right 0. The e4m3 inputs are read by TMA, so their
    pointers and strides must be multiples of 16 bytes (16 elements), and
    out's of 8 elements: ``ValueError`` otherwise. The callers count the
    launch."""
    tensors = [t for t in (q, k, v, out, lse, *descales) if t is not None]
    _cuda.require_cuda(*tensors)
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if any(t.dtype != FP8 for t in (q, k, v)) or out.dtype != torch.bfloat16:
        raise ValueError("the fp8 forward takes float8_e4m3fn q/k/v and a "
                         "bfloat16 out")
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if h % hk or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)}")
    if lse is not None and (lse.shape != (b, h, sq) or not lse.is_contiguous()
                            or lse.dtype != torch.float32):
        raise ValueError("lse must be a contiguous fp32 (b, h, sq) tensor")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _cuda.require_aligned(t, 16, name)
    _cuda.require_aligned(out, 8, "out")
    for x in descales:
        if x is not None and (x.shape != (b, hk) or not x.is_contiguous()
                              or x.dtype != torch.float32):
            raise ValueError(f"a descale must be a contiguous fp32 ({b}, "
                             f"{hk}) tensor")
    code = _cuda.lib().xfa_flash_fwd_fp8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _cuda.ptr(lse), *(_cuda.ptr(x) for x in descales),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, hk, sq, sk, d, float(sm_scale), float(softcap),
        int(window[0]), int(window[1]), _cuda.stream())
    _cuda.check(code, "flash_fwd_fp8")


def flash_fwd_fp8(q, k, v, q_descale=None, k_descale=None, v_descale=None,
                  *, sm_scale: float, causal: bool = False,
                  window_size: Tuple[int, int] = (-1, -1),
                  softcap: float = 0.0, need_lse: bool = True):
    """The fp8 forward on (b, h, s, d) float8_e4m3fn views (≙ the TPU
    package's fwd.py with fp8 inputs, 111-168, 334-344, 639-655): q
    (b, h, sq, d), k/v (b, hk, sk, d), descales (b, hk) fp32 or None
    (ones), q's indexed by KV head. Returns (out (b, h, sq, d) bf16, lse
    (b, h, sq) fp32 of the descaled scores | None). On CUDA, out is
    allocated in (b, sq, h, d) memory order, as :func:`flash_attention_fwd`
    does; on the CPU the plain version :func:`reference.attention_fp8_ref`
    runs.

    ``flash_fwd_fp8.launches`` counts kernel launches."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    causal, window, _ = resolve_window(causal, window_size, sq, sk, False)
    if causal:
        window = (-1, 0)
    if q.device.type == "cpu":
        return attention_fp8_ref(q, k, v, q_descale, k_descale, v_descale,
                                 sm_scale=sm_scale, causal=False,
                                 window_size=window, softcap=softcap,
                                 need_lse=need_lse)
    descales = [fp8_descale_arg(x, b, hk, q.device)
                for x in (q_descale, k_descale, v_descale)]
    out = torch.empty(b, sq, h, d, dtype=torch.bfloat16,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    launch_flash_fwd_fp8(q, k, v, out, lse, descales, sm_scale=sm_scale,
                         window=window, softcap=softcap)
    flash_fwd_fp8.launches += 1
    return out, lse


flash_fwd_fp8.launches = 0


def check_fp8(q, k, v, bias, dropout_p, flags) -> None:
    """The fp8 route's refusals, as the TPU package's (fwd.py:639-643; FA3
    has no such flags either): q, k and v all e4m3; no bias, dropout,
    FlashMask, block mask, segment ids or positions (``ValueError``)."""
    if not all(t.dtype == FP8 for t in (q, k, v)):
        raise ValueError(
            f"the fp8 forward takes float8_e4m3fn q, k and v, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias is not None:  # as the TPU package's fwd.py:641
        raise ValueError("the fp8 forward takes no attention bias")
    if dropout_p > 0.0:
        raise ValueError("the fp8 forward takes no dropout")
    named = [name for name, t in flags.items() if t is not None]
    if named:
        raise ValueError(f"the fp8 forward takes no {named}")


def check_supported(q, bias, dropout_p, where: str) -> None:
    """Raise on what the port lacks on the card, before any work: dropout
    in float32 or beside an attention bias (:data:`common.SLICE_DROPOUT`;
    the plain versions on CPU tensors take both). fp8 with dropout is
    check_fp8's ``ValueError``, as in the TPU package."""
    if dropout_p > 0.0 and q.device.type != "cpu" and (
            q.dtype == F32 or bias is not None):
        what = "float32" if q.dtype == F32 else "an attention bias"
        raise NotImplementedError(
            f"{where}: dropout with {what} on the card: {SLICE_DROPOUT}")


def build_masks(b: int, h: int, sq: int, sk: int, causal: bool,
                window_size=(-1, -1), *, flashmask_vecs=None,
                flashmask_mode=None, block_mask=None, q_segment_ids=None,
                kv_segment_ids=None, q_positions=None, kv_positions=None):
    """(causal, masks): the plain causal flag and the :class:`KernelMasks`
    of every flag (:func:`common.resolve_window`); made once per call of
    the autograd function and shared by its forward and backward."""
    causal, window, pos_window = resolve_window(
        causal, window_size, sq, sk, q_positions is not None)
    return causal, KernelMasks(
        b, h, sq, sk, flashmask_vecs=flashmask_vecs,
        flashmask_mode=flashmask_mode, block_mask=block_mask, window=window,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions,
        pos_window=pos_window)


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
    flashmask_mode: Optional[str] = None,
    block_mask=None,
    q_positions=None,
    kv_positions=None,
    masks: Optional[KernelMasks] = None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Forward attention on (batch, heads, seq, head_dim) inputs.

    Returns (out, lse): out (b, h, sq, d) in q's dtype, lse (b, h, sq) fp32
    or None. The inputs may be strided views (only the head dim must be
    contiguous). On CUDA, out is allocated in (b, sq, h, d) memory order and
    returned as a (b, h, sq, d) view, so that swapping it back to the
    projection layout is free.

    flashmask_vecs: optional (b, hm, NV, sk) int32 FlashMask row-index
    vectors with ``flashmask_mode`` one of common.FM_NV's keys; hm divides
    h. block_mask: optional (mask, gq, gk), mask (b|1, hm|1, ceil(sq/gq),
    ceil(sk/gk)) 0/1, granularities multiples of 64. window_size: (left,
    right), -1 no bound, bottom-right aligned; causal sets right to 0.
    q_segment_ids / kv_segment_ids: (b, sq) / (b, sk) int, pairs with
    equal ids attend. q_positions / kv_positions: (b, sq) / (b, sk) int;
    the causal and window bounds then apply to the positions (kpos <= qpos
    + right, kpos >= qpos - left) instead of the row and key indices. All
    flags combine. Tiles that the flags turn off everywhere are skipped
    unread; rows that see no key give 0 and lse +inf. ``masks``: the
    flags already made by :func:`build_masks` (then ``causal`` must be
    the flag it returned and the other flags are not read).

    bias: an additive (sq, sk), (bb, sq, sk) or (bb, bh, sq, sk) fp32 or
    bf16 tensor (:func:`bias_view`), added to the scores after softcap and
    before the masks; not with a FlashMask or block mask.

    float8_e4m3fn q, k and v run :func:`flash_fwd_fp8` with the (b, hk)
    ``q_descale`` / ``k_descale`` / ``v_descale`` (None: ones); out is then
    bf16, and bias, dropout and the mask flags raise ``ValueError``.

    float32 q/k/v on the card run :func:`flash_fwd_fp32` (every flag, and
    the bias).

    dropout_p > 0 drops elements of P by :func:`common.dropout_keep_mask`
    keyed on ``dropout_seed`` (an int or a one-element int tensor); on the
    card in bf16 without a bias (else ``NotImplementedError``,
    :func:`check_supported`).

    ``flash_attention_fwd.launches`` counts the bf16 kernel's launches,
    ``flash_fwd_fp8.launches`` the e4m3 instantiation's,
    ``flash_fwd_fp32.launches`` the fp32 kernel's.
    """
    if FP8 in (q.dtype, k.dtype, v.dtype):
        if masks is not None:  # made by the autograd entry: a window at most
            window_size = masks.window
            flags = dict(flashmask_vecs=masks.fm_vecs, block_mask=masks.bm,
                         segment_ids=masks.seg, positions=masks.pos)
        else:
            flags = dict(flashmask_vecs=flashmask_vecs, block_mask=block_mask,
                         q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids,
                         q_positions=q_positions, kv_positions=kv_positions)
        check_fp8(q, k, v, bias, dropout_p, flags)
        return flash_fwd_fp8(q, k, v, q_descale, k_descale, v_descale,
                             sm_scale=sm_scale, causal=causal,
                             window_size=window_size, softcap=softcap,
                             need_lse=need_lse)
    check_supported(q, bias, dropout_p, "flash_attention_fwd")
    drop = Dropout.make(dropout_p, dropout_seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if bias is not None:
        bias = bias_view(bias, b, h, sq, sk)
    if masks is None:
        causal, masks = build_masks(
            b, h, sq, sk, causal, window_size, flashmask_vecs=flashmask_vecs,
            flashmask_mode=flashmask_mode, block_mask=block_mask,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions)
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                 softcap=softcap, need_lse=need_lse,
                                 mask=masks.keep(h), bias=bias, dropout=drop)
    if q.dtype == F32:
        return flash_fwd_fp32(q, k, v, sm_scale=sm_scale,
                              window=fp32_window(masks, causal),
                              softcap=softcap, need_lse=need_lse, masks=masks,
                              causal=causal, bias=bias)
    out = torch.empty(b, sq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    launch_flash_fwd(q, k, v, out, lse, sm_scale=sm_scale, causal=causal,
                     softcap=softcap, masks=masks, bias=bias, dropout=drop)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
