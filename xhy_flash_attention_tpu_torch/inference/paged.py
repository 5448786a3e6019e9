"""Paged KV cache and paged flash-decode (≙ xhy_flash_attention_tpu
inference/paged.py).

A page is one record holding both K and V rows of every KV head:
kv_pages (num_pages, kv_heads, 2, page_size, head_dim). A sequence reaches
its pages through page_table (batch, max_pages_per_seq). Quantization scales
are not paged: they live in a per-sequence linear buffer kv_scales (batch,
kv_heads, 2, max_pages_per_seq * page_size) fp32.

On CUDA tensors the attention runs in csrc/paged_decode.cu, one C entry behind
two entries with their own launch counts, routed as the TPU package routes
its two kernels: `paged_decode_chunked` (≙ `_paged_decode_chunked_kernel`,
paged.py:219) when page_size < 8192, more than one page per sequence and
head_dim % 128 == 0, else `paged_decode_page` (≙ `_paged_decode_kernel`,
paged.py:149). On CPU tensors both take the plain version
:func:`paged_flash_decode_ref`.

The C entry has two regimes, chosen from sq * h / hk (a shape, so that a
call can be captured in a CUDA graph): up to 16 rows per KV head the decode
regime (csrc/flash_decode.cu's kernel with keys reached through the page
table: each (batch, kv head) on a cluster of 1-8 CTAs, each CTA a
tile-aligned run of the visible keys), else the prefill regime (wgmma over
blocks of 128 rows and tiles of 128 keys). fp32 pages take fp32 queries:
the decode regime's fp32 instantiation, and for the prefill regime
csrc/flash_fp32.cu's forward (three TF32 products on the tensor cores) with
K/V through the page table: by TMA when the page size is a multiple of its
key tile (64 keys at d 64, 32 at d 128), else by cp.async. :func:`paged_launch_plan`,
:func:`decode_cta_runs` and :func:`prefill_tile_plan` mirror the kernel's
launch plan in plain Python; ``launch_paged(..., cluster=c)`` forces the
cluster size of the decode regime.

The TPU package is functional; here `append_paged_kv` writes the pages and
scales in place and returns a new PagedKVCache whose lengths tensor is new:
the lengths that every layer of one model call starts from stay untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import _cuda
from ..ops.flash_attention.common import (NEG_INF, SLICE_DTYPES, cdiv,
                                          require_inference)
from ..ops.flash_attention.fwd import launch_flash_fwd_fp32
from ..ops.flash_attention.decode_kernel import (CLUSTER_SIZES, MAX_ROWS,
                                                 TILE, contiguous_q,
                                                 cta_chunk, decode_launch_plan)
from ..ops.quant import QUANT_DTYPES, bits, quantize_kv

__all__ = ["PagedKVCache", "append_paged_kv", "decode_cta_runs", "hk_of",
           "launch_paged", "paged_decode_chunked", "paged_decode_page",
           "paged_flash_decode", "paged_flash_decode_ref", "paged_launch_plan",
           "prefill_tile_plan"]

_CHUNK_TOKENS = 8192  # the TPU package's routing threshold (paged.py:518)
PREFILL_TILE_M = 128  # PackGQA rows per CTA of the prefill regime
PREFILL_TILE_N = 128  # keys per tile of the prefill regime


@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged KV storage.

    kv_pages: (num_pages, kv_heads, 2, page_size, head_dim); index 0 on the
        third axis is K, 1 is V.
    page_table: (batch, max_pages_per_seq) int32, the physical page of each
        logical block; entries past a sequence's pages are clamped out by
        ``lengths``.
    lengths: (batch,) int32 valid tokens per sequence.
    kv_scales: None for float pages; (batch, kv_heads, 2, max_pages_per_seq *
        page_size) fp32 per-token K/V scales for int8 / e4m3 pages, in
        sequence-linear layout.
    active: None, or (batch,) bool: the slots whose next append counts its
        tokens. None means ``lengths > 0`` (decode: an empty slot is
        inactive). Chunked prefill sets it so that a prompt's first chunk,
        appended to an empty slot, counts.
    """

    kv_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    kv_scales: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None

    @property
    def k_pages(self) -> torch.Tensor:
        return self.kv_pages[:, :, 0]

    @property
    def v_pages(self) -> torch.Tensor:
        return self.kv_pages[:, :, 1]

    @property
    def page_size(self) -> int:
        return self.kv_pages.shape[3]

    @property
    def quantized(self) -> bool:
        return self.kv_scales is not None

    @staticmethod
    def create(num_pages: int, kv_heads: int, page_size: int, head_dim: int,
               batch: int, max_pages_per_seq: int, dtype=torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        sc = (torch.ones(batch, kv_heads, 2, max_pages_per_seq * page_size,
                         dtype=torch.float32, device=device)
              if dtype in QUANT_DTYPES else None)
        return PagedKVCache(
            kv_pages=torch.zeros(num_pages, kv_heads, 2, page_size, head_dim,
                                 dtype=dtype, device=device),
            page_table=torch.zeros(batch, max_pages_per_seq, dtype=torch.int32,
                                   device=device),
            lengths=torch.zeros(batch, dtype=torch.int32, device=device),
            kv_scales=sc)

    @staticmethod
    def from_kv(k_pages, v_pages, page_table, lengths, k_scales=None,
                v_scales=None) -> "PagedKVCache":
        """Build from separate K/V page arrays (num_pages, kv_heads,
        page_size, head_dim) and, optionally, page-layout scales (num_pages,
        kv_heads, 1, page_size), gathered into the linear layout through the
        page table."""
        kv = torch.stack([bits(k_pages), bits(v_pages)], dim=2).view(
            k_pages.dtype)
        sc = None
        if k_scales is not None:
            b, npp = page_table.shape
            hk, ps = k_pages.shape[1], k_pages.shape[2]

            def lin(s):
                g = s[:, :, 0][page_table.long()]  # (b, npp, hk, ps)
                return g.permute(0, 2, 1, 3).reshape(b, hk, npp * ps)

            sc = torch.stack([lin(k_scales), lin(v_scales)], dim=2)
        return PagedKVCache(kv, page_table, lengths, sc)

    def clone(self) -> "PagedKVCache":
        return dataclasses.replace(
            self, kv_pages=self.kv_pages.clone(),
            kv_scales=None if self.kv_scales is None else self.kv_scales.clone())


def hk_of(cache: PagedKVCache) -> int:
    return cache.kv_pages.shape[1]


def _gather(cache: PagedKVCache):
    """Dense per-sequence K, V (b, hk, npp * ps, d) and scales (b, hk,
    npp * ps) or None, through the page table."""
    P, hk, _, ps, d = cache.kv_pages.shape
    b, npp = cache.page_table.shape
    table = cache.page_table.long().clamp(0, P - 1)
    kv = bits(cache.kv_pages)[table].view(cache.kv_pages.dtype).permute(
        0, 2, 3, 1, 4, 5).reshape(b, hk, 2, npp * ps, d)
    sc = cache.kv_scales
    return (kv[:, :, 0], kv[:, :, 1],
            None if sc is None else sc[:, :, 0], None if sc is None else sc[:, :, 1])


def paged_flash_decode_ref(q, cache: PagedKVCache, softmax_scale: float,
                           window_size=(-1, -1), softcap: float = 0.0):
    """Plain version of the paged kernels: the same fp32 arithmetic over the
    pages gathered into dense sequences; P (times the V scales) is rounded
    to q's dtype for P.V, as the kernels do. q (b, sq, h, d) -> (b, sq, h, d)."""
    b, sq, h, d = q.shape
    k, v, ks, vs = _gather(cache)
    hk, S = k.shape[1], k.shape[2]
    g = h // hk
    qr = q.float().reshape(b, sq, hk, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hk, sq * g, d)
    s = torch.einsum("bhrd,bhtd->bhrt", qr, k.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = s * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    cols = torch.arange(S, device=q.device)
    si = torch.arange(sq * g, device=q.device) // g
    pos = cache.lengths.to(torch.int64)[:, None] - sq + si[None]  # (b, rows)
    mask = cols[None, None] <= pos[:, :, None]
    if window_size[0] >= 0:
        mask = mask & (cols[None, None] >= pos[:, :, None] - window_size[0])
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp_min(m, 0.5 * NEG_INF))
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, :, None, :]
    pv = torch.einsum("bhrt,bhtd->bhrd", p.to(q.dtype).float(), v.float())
    out = pv * torch.where(l == 0.0, 0.0, 1.0 / l)
    return out.reshape(b, hk, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d).to(q.dtype)


def paged_launch_plan(b: int, sq: int, h: int, hk: int, page_size: int,
                      pages_per_seq: int, sm_count: int,
                      cluster: Optional[int] = None) -> dict:
    """The launch of csrc/paged_decode.cu for these shapes, from shapes
    alone (never from lengths, so that a call can be captured in a CUDA
    graph).

    Up to 16 rows per KV head (sq * h / hk), ``regime`` "decode": ``cluster``
    CTAs per (batch, kv head) and ``chunk`` keys per CTA of a fully visible
    sequence. Unless forced, the cluster doubles from 1 while the grid stays
    within two waves of the two CTAs an SM holds and each CTA keeps a tile,
    up to 8 (decode_launch_plan over the capacity with four times the SM
    count): a paged batch is ragged, its longest sequence sets the time and
    the CTAs of short or empty ones end at once, so the longest one's keys
    are spread wide (8 at the engine's b8 hk8). More rows, "prefill": one
    CTA per block of 128 rows per (batch, kv head), and ``tma_pages`` when
    the page size lets bf16 K/V tiles come by TMA (1-byte pages come by
    cp.async, to be converted)."""
    rows = sq * (h // hk)
    cap = page_size * pages_per_seq
    if rows <= MAX_ROWS:
        if cluster is None:
            # two CTAs fit on an SM, and two waves of them are allowed
            cluster, _ = decode_launch_plan(b, hk, cap, 1, 0, 4 * sm_count)
        return dict(regime="decode", cluster=cluster, ctas=cluster * b * hk,
                    chunk=cdiv(cdiv(cap, TILE), cluster) * TILE)
    n_mb = cdiv(rows, PREFILL_TILE_M)
    return dict(regime="prefill", cluster=1, ctas=n_mb * hk * b,
                tma_pages=page_size % PREFILL_TILE_N == 0)


def decode_cta_runs(length: int, sq: int, window_left: int, cap: int,
                    cluster: int):
    """Keys [lo, hi) that each CTA of a cluster reads in the decode regime
    for a sequence of ``length`` (the sq new tokens included): the run of
    visible keys [start, stop), start = max(0, length - sq - window_left)
    with a window, stop = min(length, cap), cut as flash_decode.cu cuts it
    (:func:`cta_chunk`). Keys in [lo, start) are read as zeros."""
    start = max(0, length - sq - window_left) if window_left >= 0 else 0
    stop = min(length, cap)
    return [cta_chunk(start, stop, 0, rank, cluster)
            for rank in range(cluster)]


def prefill_tile_plan(length: int, sq: int, g: int, cap: int,
                      window_left: int, m_block: int):
    """The key tiles that CTA ``m_block`` of the prefill regime visits, in
    its order, as (n0, masked): rows r0 .. r1 of the block see keys from
    max(0, pos(r0) - window_left) to min(pos(r1), cap - 1), pos(r) = length
    - sq + r // g; tiles of 128 keys from the last to the first; a tile is
    masked unless every row of the block sees all of it. The kernel's
    block_plan and tile_masked compute the same."""
    rows = sq * g
    r0 = m_block * PREFILL_TILE_M
    r1 = min(r0 + PREFILL_TILE_M, rows) - 1
    pos_first = length - sq + r0 // g
    pos_last = length - sq + r1 // g
    hi = min(pos_last, cap - 1)
    lo = max(0, pos_first - window_left) if window_left >= 0 else 0
    if hi < lo:
        return []
    n = PREFILL_TILE_N
    plan = []
    for t in range(hi // n, lo // n - 1, -1):
        n0 = t * n
        full = (n0 + n - 1 <= min(pos_first, cap - 1)
                and (window_left < 0 or n0 >= pos_last - window_left))
        plan.append((n0, not full))
    return plan


def launch_paged(q, cache: PagedKVCache, *, softmax_scale: float,
                 window_size=(-1, -1), softcap: float = 0.0,
                 cluster: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/paged_decode.cu and return the output (b, sq, h, d); on
    fp32 pages the prefill regime is the paged instantiation of
    csrc/flash_fp32.cu's forward (fwd.launch_flash_fwd_fp32).
    ``cluster`` forces the CTAs per cluster of the decode regime (1, 2, 4 or
    8; the tests and chip_smoke.py set it), else :func:`paged_launch_plan`
    picks it. The callers count the launch."""
    pages = cache.kv_pages
    tensors = [q, pages, cache.page_table, cache.lengths]
    if cache.kv_scales is not None:
        tensors.append(cache.kv_scales)
    _cuda.require_cuda(*tensors)
    b, sq, h, d = q.shape
    P, hk, _, ps, _ = pages.shape
    npp = cache.page_table.shape[1]
    f32 = q.dtype == torch.float32 and pages.dtype == torch.float32
    if not f32 and (q.dtype != torch.bfloat16 or pages.dtype not in (
            torch.bfloat16, *QUANT_DTYPES)):
        raise NotImplementedError(
            f"the CUDA paged kernel takes bfloat16 queries with bfloat16, "
            f"int8 or float8_e4m3fn pages, or float32 queries with float32 "
            f"pages (got {q.dtype}, {pages.dtype}); fp16 comes with "
            f"{SLICE_DTYPES}")
    if d not in (64, 128):
        raise NotImplementedError(f"head dim {d}: the kernel takes 64 or 128")
    if pages.shape[4] != d or h % hk or cache.page_table.shape[0] != b \
            or cache.lengths.shape != (b,):
        raise ValueError(f"shapes q {tuple(q.shape)} pages {tuple(pages.shape)}"
                         f" table {tuple(cache.page_table.shape)}")
    if cache.quantized != (pages.dtype in QUANT_DTYPES):
        raise TypeError("int8 / e4m3 pages need kv_scales, float pages none")
    for t, name in ((cache.page_table, "page_table"),
                    (cache.lengths, "lengths")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if not pages.is_contiguous() or (
            cache.quantized and not cache.kv_scales.is_contiguous()):
        raise ValueError("pages and scales must be contiguous")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster}: the kernel takes {CLUSTER_SIZES}")
    _cuda.require_aligned(pages, 16, "kv_pages")
    plan = paged_launch_plan(b, sq, h, hk, ps, npp,
                             _cuda.sm_count(q.device.index), cluster)
    q = contiguous_q(q)
    out = torch.empty_like(q)
    if f32 and plan["regime"] == "prefill":
        launch_flash_fwd_fp32(
            q.transpose(1, 2), None, None, out.transpose(1, 2), None,
            sm_scale=softmax_scale, window=(int(window_size[0]), 0),
            softcap=softcap, paged=(pages, cache.page_table, cache.lengths))
        return out
    code = _cuda.lib().xfa_paged_decode(
        q.data_ptr(), pages.data_ptr(), _cuda.ptr(cache.kv_scales),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(), out.data_ptr(),
        b, sq, h, hk, ps, npp, P, d, _cuda.cache_dtype_code(pages),
        float(softmax_scale), float(softcap), int(window_size[0]),
        plan["cluster"], _cuda.stream())
    _cuda.check(code, "paged_decode")
    return out


def paged_decode_page(q, cache: PagedKVCache, *, softmax_scale: float,
                      window_size=(-1, -1), softcap: float = 0.0):
    """The entry that stands for `_paged_decode_kernel` (paged.py:149).
    ``paged_decode_page.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, cache, softmax_scale, window_size,
                                      softcap)
    out = launch_paged(q, cache, softmax_scale=softmax_scale,
                       window_size=window_size, softcap=softcap)
    paged_decode_page.launches += 1
    return out


def paged_decode_chunked(q, cache: PagedKVCache, *, softmax_scale: float,
                         window_size=(-1, -1), softcap: float = 0.0):
    """The entry that stands for `_paged_decode_chunked_kernel`
    (paged.py:219). ``paged_decode_chunked.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, cache, softmax_scale, window_size,
                                      softcap)
    out = launch_paged(q, cache, softmax_scale=softmax_scale,
                       window_size=window_size, softcap=softcap)
    paged_decode_chunked.launches += 1
    return out


paged_decode_page.launches = 0
paged_decode_chunked.launches = 0


def paged_flash_decode(
    q: torch.Tensor,
    cache: PagedKVCache,
    *,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
) -> torch.Tensor:
    """Decode attention against a paged cache.

    q: (b, sq, h, d) new queries, whose K/V must already be appended
    (:func:`append_paged_kv` first). Returns (b, sq, h, d).
    """
    require_inference(q)
    d = q.shape[-1]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    npp = cache.page_table.shape[1]
    entry = (paged_decode_chunked
             if cache.page_size < _CHUNK_TOKENS and npp > 1 and d % 128 == 0
             else paged_decode_page)
    return entry(q, cache, softmax_scale=softmax_scale,
                 window_size=window_size, softcap=softcap)


def append_paged_kv(
    cache: PagedKVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    num_valid: Optional[torch.Tensor] = None,
) -> PagedKVCache:
    """Append sq tokens per sequence into their pages, in place.

    k_new/v_new: (b, hk, sq, d). The page table must already map pages for
    the written range; writes past it land on whatever page the table names
    (the engine's trash page). Returns a PagedKVCache over the same pages and
    scales with new lengths ``lengths + num_valid``; ``cache.lengths`` itself
    is not changed.

    num_valid: (b,) tokens to account per sequence. By default every active
    slot (``cache.active``, or ``lengths > 0``) counts all sq tokens and the
    others none. All sq rows are written whatever num_valid says: rows past
    it land beyond the accounted length, where the kernels never read and
    later appends overwrite. Scale writes past the scale buffer are dropped.
    """
    b, hk, sq, d = k_new.shape
    ps = cache.page_size
    npp = cache.page_table.shape[1]
    if num_valid is None:
        active = cache.active if cache.active is not None else cache.lengths > 0
        num_valid = torch.where(active, sq, 0)
    num_valid = torch.as_tensor(num_valid, device=cache.lengths.device).to(
        cache.lengths.dtype)
    pos = cache.lengths.long()[:, None] + torch.arange(
        sq, device=k_new.device)[None]                       # (b, sq)
    blk = (pos // ps).clamp(0, npp - 1)
    pid = cache.page_table.long().gather(1, blk).reshape(-1)
    off = (pos % ps).reshape(-1)

    def write(k_rows, v_rows):
        # (b, hk, sq, d) -> (b * sq, hk, 2, d) rows written to
        # (page, :, :, off, :): one index_put covers K and V
        k_rows, v_rows = (bits(x.to(cache.kv_pages.dtype)) for x in (k_rows, v_rows))
        rows = torch.stack([k_rows.transpose(1, 2).reshape(b * sq, hk, d),
                            v_rows.transpose(1, 2).reshape(b * sq, hk, d)],
                           dim=2)
        bits(cache.kv_pages)[pid, :, :, off] = rows

    if cache.quantized:
        kq = quantize_kv(k_new, cache.kv_pages.dtype)
        vq = quantize_kv(v_new, cache.kv_pages.dtype)
        write(kq.values, vq.values)
        sc_rows = torch.stack([kq.scales[..., 0].transpose(1, 2),
                               vq.scales[..., 0].transpose(1, 2)],
                              dim=-1)                        # (b, sq, hk, 2)
        # a write past the buffer is dropped: it goes to the sequence's
        # last committed position instead and writes back what is there
        # (no boolean indexing, which would wait for the device)
        cap = cache.kv_scales.shape[-1]
        keep = pos < cap
        sink = (cache.lengths.long() - 1).remainder(cap)[:, None]
        tgt = torch.where(keep, pos, sink)
        bidx = torch.arange(b, device=pos.device)[:, None].expand(b, sq)
        old = cache.kv_scales[bidx, :, :, tgt]
        cache.kv_scales[bidx, :, :, tgt] = torch.where(
            keep[..., None, None], sc_rows, old)
    else:
        write(k_new, v_new)
    return PagedKVCache(cache.kv_pages, cache.page_table,
                        cache.lengths + num_valid, cache.kv_scales)
