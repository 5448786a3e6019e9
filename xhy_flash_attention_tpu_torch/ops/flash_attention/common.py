"""Shared helpers of the attention ops (≙ xhy_flash_attention_tpu
ops/flash_attention/common.py).

The TPU package's `BlockSizes` table is not carried over: it was tuned for
the TPU's vector memory. Tile sizes of the port belong to its kernels
(csrc/*.cu); the key tiles that the FlashMask block stats follow are
mirrored here.

FlashMask (`common.py:147-280` in the JAX package): each key column carries
up to four row indices describing half-open masked row bands, and per key
tile max/min of each vector let a kernel skip tiles that are masked
everywhere and bypass the elementwise band test on tiles masked nowhere.
`expand_block_mask` and `effective_kv_table` are not ported: they build TPU
DMA descriptors, while the CUDA kernels read the block mask at its own
granularity.
"""

from __future__ import annotations

import torch

# Large-but-finite mask value, as in the TPU package: exp(masked - masked)
# never produces NaN.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
NEG_INF = DEFAULT_MASK_VALUE

# Kernel numbers are those of the TPU kernel table (PERF.md section 6,
# ROADMAP.md queue B). What is not ported yet names the slice that brings
# it.
NEXT_SLICES = "(ROADMAP.md, 'Next slices of the port')"
SLICE_VARLEN = ("slice 5 (varlen/BERT: segments, positions, window, bias) "
                + NEXT_SLICES)
SLICE_DROPOUT = "slice 6 (dropout) " + NEXT_SLICES
SLICE_DTYPES = ("slice 7 (fp16/fp32 and fp8 inputs, weight-only "
                "quantization, remat) " + NEXT_SLICES)
SLICE_MODELS = ("slice 8 (the other models and the vision trainer) "
                + NEXT_SLICES)
SLICE_PARALLEL = "slice 9 (parallelism) " + NEXT_SLICES
NO_BACKWARD = (
    "attention against a KV cache (dense, paged or split-KV decode) has no "
    "backward, as in the TPU package: call it under torch.no_grad() or "
    "torch.inference_mode()"
)
CUDA_DTYPE_NOT_PORTED = (
    "the CUDA attention kernel (TPU kernels #1 and #5) takes bfloat16 "
    f"q/k/v; fp16 and fp32 come with {SLICE_DTYPES}"
)

# FlashMask block stats are taken per key tile of each kernel (128 keys for
# the forward and dK/dV, bwd.py bwd_dq_tile_n for dQ). FlashMask vectors are
# padded to a multiple of FM_PAD_KEYS, which every one of those tiles
# divides (and which keeps the kernels' TMA starts of the bands 16-byte
# aligned).
FM_PAD_KEYS = 128


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


# ---------------------------------------------------------------- FlashMask

# number of index vectors per mode
FM_NV = {"causal_1": 1, "causal_2": 2, "full_2": 2, "full_4": 4}
# mode codes of csrc/common.cuh (FmMode)
FM_CODES = {"causal_1": 1, "causal_2": 2, "full_2": 3, "full_4": 4}
# pad value per vector position (starts pad 0, ends pad "huge"): padded
# columns read as fully masked, which keeps block stats conservative
FM_BIG = 2 ** 30
FM_PAD = {
    "causal_1": (0,),
    "causal_2": (0, FM_BIG),
    "full_2": (0, FM_BIG),
    "full_4": (0, FM_BIG, 0, FM_BIG),
}


def fm_mode_for(causal: bool, num_vecs: int) -> str:
    """Map (causal, #vectors) to a FlashMask mode."""
    if causal and num_vecs == 1:
        return "causal_1"
    if causal and num_vecs == 2:
        return "causal_2"
    if not causal and num_vecs == 2:
        return "full_2"
    if not causal and num_vecs == 4:
        return "full_4"
    raise ValueError(
        f"flashmask: causal={causal} with {num_vecs} index vectors is not a "
        "valid combination (causal: 1 or 2; non-causal: 2 or 4)"
    )


def fm_pad_vecs(vecs: torch.Tensor, mode: str, block_k: int) -> torch.Tensor:
    """Pad the column axis of (b, hm, NV, sk) vectors to a multiple of
    ``block_k`` with values that read as fully masked columns; int32,
    contiguous."""
    b, hm, nv, sk = vecs.shape
    vecs = vecs.to(torch.int32)
    skp = round_up(sk, block_k)
    if skp == sk:
        return vecs.contiguous()
    pads = torch.tensor(FM_PAD[mode], dtype=torch.int32, device=vecs.device)
    pads = pads[None, None, :, None].expand(b, hm, nv, skp - sk)
    return torch.cat([vecs, pads], dim=-1).contiguous()


def fm_block_stats(vecs_padded: torch.Tensor, block_k: int) -> torch.Tensor:
    """Per key tile [max, min] of each vector: (b, hm, NV, skp) int32 with
    skp % block_k == 0 -> (b, hm, skp / block_k, NV, 2) int32 contiguous,
    read by the kernels at [b, hm, tile, v, {0: max, 1: min}]."""
    b, hm, nv, skp = vecs_padded.shape
    r = vecs_padded.reshape(b, hm, nv, skp // block_k, block_k)
    st = torch.stack([r.amax(-1), r.amin(-1)], dim=-1)  # (b, hm, nv, nkv, 2)
    return st.transpose(2, 3).contiguous()


def fm_skip_bypass(mode: str, st, q_start, q_end):
    """Tile decisions from the stats of one key tile.

    st(v, which): getter, which 0 = max, 1 = min over the tile. Rows
    [q_start, q_end). Returns (skip, bypass): skip when every element of the
    tile is masked, bypass when none is. Both are conservative across
    columns. Works on ints and on broadcasting tensors alike.
    """
    lts_max, lts_min = st(0, 0), st(0, 1)
    if mode == "causal_1":
        return q_start >= lts_max, q_end <= lts_min
    if mode == "causal_2":
        lte_max, lte_min = st(1, 0), st(1, 1)
        return ((q_start >= lts_max) & (q_end <= lte_min),
                (q_end <= lts_min) | (q_start >= lte_max))
    if mode == "full_2":
        ute_max, ute_min = st(1, 0), st(1, 1)
        return ((q_start >= lts_max) | (q_end <= ute_min),
                (q_end <= lts_min) & (q_start >= ute_max))
    if mode == "full_4":
        lte_max, lte_min = st(1, 0), st(1, 1)
        uts_max, uts_min = st(2, 0), st(2, 1)
        ute_max, ute_min = st(3, 0), st(3, 1)
        skip = (((q_start >= lts_max) & (q_end <= lte_min))
                | ((q_start >= uts_max) & (q_end <= ute_min)))
        bypass = (((q_end <= lts_min) | (q_start >= lte_max))
                  & ((q_end <= uts_min) | (q_start >= ute_max)))
        return skip, bypass
    raise ValueError(mode)


def fm_banned(mode: str, vecs: torch.Tensor, rows: torch.Tensor):
    """Elementwise FlashMask, True = masked out. ``vecs`` (..., NV, sk)
    per-column vectors, ``rows`` (sq, 1) row ids; returns (..., sq, sk).
    Bands are half-open [start, end)."""
    vec = lambda i: vecs[..., i:i + 1, :]  # noqa: E731  (..., 1, sk)
    lts = vec(0)
    if mode == "causal_1":
        return rows >= lts
    if mode == "causal_2":
        return (rows >= lts) & (rows < vec(1))
    if mode == "full_2":
        return (rows >= lts) | (rows < vec(1))
    if mode == "full_4":
        return (((rows >= lts) & (rows < vec(1)))
                | ((rows >= vec(2)) & (rows < vec(3))))
    raise ValueError(mode)


def fm_bands(vecs_padded: torch.Tensor, mode: str) -> torch.Tensor:
    """Each column's masked rows as two half-open bands: (b, hm, NV, skp)
    vectors -> (b, hm, skp, 4) int32 [lo1, hi1, lo2, hi2], a row masked when
    it lies in either band (rows are >= 0 and < FM_BIG), the form the
    masked kernels test elementwise."""
    v = vecs_padded.to(torch.int32)
    zero = torch.zeros_like(v[:, :, 0])
    big = torch.full_like(zero, FM_BIG)
    if mode == "causal_1":
        cols = (v[:, :, 0], big, zero, zero)
    elif mode == "causal_2":
        cols = (v[:, :, 0], v[:, :, 1], zero, zero)
    elif mode == "full_2":
        cols = (v[:, :, 0], big, zero, v[:, :, 1])
    else:
        cols = tuple(v[:, :, i] for i in range(4))
    return torch.stack(cols, -1).contiguous()


def fm_keep_mask(vecs: torch.Tensor, mode: str, sq: int) -> torch.Tensor:
    """Dense keep mask (True = attend) of (b, hm, NV, sk) vectors: (b, hm,
    sq, sk). The causal part of a causal mode is not in it: the attention
    functions apply their causal flag themselves."""
    rows = torch.arange(sq, device=vecs.device, dtype=torch.int32)[:, None]
    return ~fm_banned(mode, vecs.to(torch.int32), rows)


def check_flashmask(vecs: torch.Tensor, mode: str, b: int, h: int, sk: int):
    if mode not in FM_NV:
        raise ValueError(f"flashmask mode {mode!r}, not one of {list(FM_NV)}")
    if vecs.dim() != 4 or vecs.shape[0] != b or vecs.shape[2] != FM_NV[mode] \
            or vecs.shape[3] != sk or h % vecs.shape[1]:
        raise ValueError(
            f"flashmask vectors {tuple(vecs.shape)} must be (b={b}, hm, "
            f"{FM_NV[mode]}, sk={sk}) with hm dividing h={h}")


# -------------------------------------------------------------- block mask

def check_block_mask(block_mask, b: int, h: int, sq: int, sk: int,
                     tile: int = 64):
    """Validate ``block_mask = (mask, gq, gk)``: mask (b|1, hm|1,
    ceil(sq/gq), ceil(sk/gk)) 0/1 with hm dividing h, and granularities that
    are multiples of ``tile``: the kernels decide per 64-row or 64-key part
    of their 128-row and 128-key blocks and tiles."""
    mask, gq, gk = block_mask
    if gq % tile or gk % tile or gq <= 0 or gk <= 0:
        raise ValueError(f"block mask granularity ({gq}, {gk}) must be a "
                         f"positive multiple of {tile}")
    want = (cdiv(sq, gq), cdiv(sk, gk))
    if mask.dim() != 4 or mask.shape[0] not in (1, b) \
            or h % mask.shape[1] or tuple(mask.shape[2:]) != want:
        raise ValueError(f"block mask {tuple(mask.shape)} must be (b|1, "
                         f"hm|1, {want[0]}, {want[1]}) with hm dividing {h}")


def block_keep_mask(mask: torch.Tensor, gq: int, gk: int, sq: int,
                    sk: int) -> torch.Tensor:
    """Dense keep mask (b|1, hm|1, sq, sk) of a user-granularity block
    mask."""
    m = mask.to(torch.bool)
    m = m.repeat_interleave(gq, dim=2).repeat_interleave(gk, dim=3)
    return m[:, :, :sq, :sk]


def expand_heads(mask: torch.Tensor, h: int) -> torch.Tensor:
    """Broadcast a (b|1, hm|1, sq, sk) mask to h heads: head i reads mask
    head i // (h / hm)."""
    hm = mask.shape[1]
    if hm in (1, h):
        return mask
    return mask.repeat_interleave(h // hm, dim=1)


def dense_keep_mask(sq: int, sk: int, h: int, *, flashmask_vecs=None,
                    flashmask_mode=None, block_mask=None):
    """The keep mask (b|1, hm|1, sq, sk) of the FlashMask and block-mask
    flags together, or None when neither is given."""
    keep = None
    if flashmask_vecs is not None:
        keep = fm_keep_mask(flashmask_vecs, flashmask_mode, sq)
    if block_mask is not None:
        bm = block_keep_mask(*block_mask, sq, sk)
        if keep is not None and 1 not in (keep.shape[1], bm.shape[1]):
            keep, bm = expand_heads(keep, h), expand_heads(bm, h)
        keep = bm if keep is None else keep & bm
    return keep


class KernelMasks:
    """The FlashMask and block-mask flags as the CUDA kernels take them
    (the ``MaskParams`` of csrc/common.cuh): int32 vectors padded to a
    multiple of FM_PAD_KEYS keys, per key tile stats made once per tile
    size (the forward and dK/dV share those of 128 keys), the bands the
    kernels test elementwise (:func:`fm_bands`) made once, and the int32
    block mask at its own granularity with its batch and head strides (0
    where it broadcasts)."""

    def __init__(self, b: int, h: int, sq: int, sk: int, *,
                 flashmask_vecs=None, flashmask_mode=None, block_mask=None):
        self.fm_vecs = self.bm = self._bands = None
        self._stats = {}
        if flashmask_vecs is not None:
            check_flashmask(flashmask_vecs, flashmask_mode, b, h, sk)
            self.fm_mode = flashmask_mode
            self.fm_vecs = fm_pad_vecs(flashmask_vecs, flashmask_mode,
                                       FM_PAD_KEYS)
        if block_mask is not None:
            check_block_mask(block_mask, b, h, sq, sk)
            mask, self.gq, self.gk = block_mask
            self.bm = mask.to(torch.int32).contiguous()
            bb, hb, nq, nk = self.bm.shape
            self.bm_sb = 0 if bb == 1 else hb * nq * nk
            self.bm_sh = 0 if hb == 1 else nq * nk

    def tensors(self):
        return [t for t in (self.fm_vecs, self.bm) if t is not None]

    def stats(self, block_k: int) -> torch.Tensor:
        if block_k not in self._stats:
            self._stats[block_k] = fm_block_stats(self.fm_vecs, block_k)
        return self._stats[block_k]

    def bands(self):
        """The FlashMask bands (b, hm, skp, 4), or None without a
        FlashMask."""
        if self.fm_vecs is not None and self._bands is None:
            self._bands = fm_bands(self.fm_vecs, self.fm_mode)
        return self._bands

    @staticmethod
    def c_args(masks, block_k: int) -> tuple:
        """The 12 trailing mask arguments of the kernels' C entry points,
        with FlashMask stats taken per ``block_k`` keys."""
        fm = (None, None, 0, 1, 0)
        bm = (None, 0, 0, 1, 0, 1, 1)
        if masks is not None and masks.fm_vecs is not None:
            v = masks.fm_vecs
            fm = (v.data_ptr(), masks.stats(block_k).data_ptr(),
                  FM_CODES[masks.fm_mode], v.shape[1], v.shape[3])
        if masks is not None and masks.bm is not None:
            m = masks.bm
            bm = (m.data_ptr(), masks.bm_sb, masks.bm_sh, m.shape[1],
                  m.shape[3], masks.gq, masks.gk)
        return fm + bm
