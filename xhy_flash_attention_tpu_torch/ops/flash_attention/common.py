"""Shared helpers of the attention ops (≙ xhy_flash_attention_tpu
ops/flash_attention/common.py).

The TPU package's `BlockSizes` table was tuned for the TPU's vector
memory; :class:`BlockSizes` here is a stand-in with its field names that
reports the port's fixed H100 tiles (csrc/*.cu). The key tiles that the
FlashMask block stats follow are mirrored here.

FlashMask (`common.py:147-280` in the JAX package): each key column carries
up to four row indices describing half-open masked row bands, and per key
tile max/min of each vector let a kernel skip tiles that are masked
everywhere and bypass the elementwise band test on tiles masked nowhere.
`expand_block_mask` and `effective_kv_table` are not ported: they build TPU
DMA descriptors, while the CUDA kernels read the block mask at its own
granularity.

Attention dropout (`common.py:120-144` in the JAX package): the keep mask
is a counter-based hash of (seed, salt, global row, global column), so the
forward and the backward, with their different tilings, regenerate the
same mask; :func:`dropout_keep_mask` is its bit-exact plain version and
:class:`Dropout` the form in which the kernels and their plain versions
take it.

Sliding windows, segment ids and q/kv positions (`common.py:286-330` in
the JAX package, its forward `fwd.py:602-635`): a window bounds the keys of
each row, bottom-right aligned (key c visible to row r when r + offset -
left <= c <= r + offset + right, offset = sk - sq), or with positions the
same bounds on the position values (the row/key window is then off);
segment ids make a pair visible only when the ids are equal. Per kernel
tile min/max of the ids and positions (:func:`token_stats`) let a kernel
skip a tile pair or bypass its elementwise test, and per block the range
of tiles that may hold a visible pair (:func:`tile_ranges`) bounds the
tiles its producer considers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Large-but-finite mask value, as in the TPU package: exp(masked - masked)
# never produces NaN.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
NEG_INF = DEFAULT_MASK_VALUE

# Kernel numbers are those of the TPU kernel table (PERF.md section 6,
# ROADMAP.md queue B). What is not ported yet names the slice that brings
# it.
NEXT_SLICES = "(ROADMAP.md, 'Next slices of the port')"
SLICE_DROPOUT = ("slice 6's rest (attention dropout in fp32 or with an "
                 "attention bias on the card) " + NEXT_SLICES)
SLICE_DTYPES = ("slice 7b (fp16 inputs to the CUDA attention kernels) "
                + NEXT_SLICES)
SLICE_MODELS = ("slice 8 (the other models and the vision trainer) "
                + NEXT_SLICES)
SLICE_PARALLEL = "slice 9 (parallelism) " + NEXT_SLICES
NO_BACKWARD = (
    "attention against a KV cache (dense, paged or split-KV decode) has no "
    "backward, as in the TPU package: call it under torch.no_grad() or "
    "torch.inference_mode()"
)
CUDA_DTYPE_NOT_PORTED = (
    "the CUDA attention kernels (TPU kernels #1-#3, #5, #6) take bfloat16 "
    "or float32 q/k/v (float8_e4m3fn through flash_attn_fp8_func, forward "
    f"only); fp16 comes with {SLICE_DTYPES}"
)

# FlashMask block stats are taken per key tile of each kernel (128 keys for
# the bf16 forward and dK/dV, bwd.py bwd_dq_tile_n for dQ, 16 to 128 for
# the fp32 kernels: kernel_tiles). FlashMask vectors are
# padded to a multiple of FM_PAD_KEYS, which every one of those tiles
# divides (and which keeps the kernels' TMA starts of the bands 16-byte
# aligned).
FM_PAD_KEYS = 128


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the attention kernels, under the JAX package's field
    names (its `common.py:80`).

    A stand-in: the TPU package picks its tiles per call, while the CUDA
    kernels' tiles are fixed per head dim (query rows and keys of the
    forward; keys and query rows of dK/dV; rows and keys of dQ), so
    :meth:`for_shape` reports them and ``block_sizes=`` is accepted by the
    entry points and ignored, as ``deterministic`` is.
    """

    block_q: int = 128
    block_k: int = 128
    block_q_dkv: int = 64
    block_k_dkv: int = 128
    block_q_dq: int = 128
    block_k_dq: int = 128

    @staticmethod
    def for_shape(seqlen_q: int, seqlen_k: int, head_dim: int,
                  dtype=None) -> "BlockSizes":
        """The kernels' tiles at ``head_dim`` (the lengths and dtype do not
        change them)."""
        del seqlen_q, seqlen_k, dtype
        return BlockSizes(block_k_dq=128 if head_dim == 64 else 64)


# ------------------------------------------------------------------ dropout

_U32 = 0xFFFFFFFF
# the hash's multipliers (JAX common.py:133-141; csrc/common.cuh)
DROP_ROW, DROP_COL, DROP_SALT = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
DROP_MIX1, DROP_MIX2 = 0x7FEB352D, 0x846CA68B


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 ``x`` in [0, 2^32) with no int64 overflow:
    c's low and high 16 bits apart (each partial product below 2^48)."""
    hi = x * (c >> 16)
    hi &= 0xFFFF
    hi <<= 16
    hi += x * (c & 0xFFFF)
    return hi.bitwise_and_(_U32)


def dropout_threshold(dropout_p: float) -> int:
    """The uint32 threshold of keep probability 1 - p: an element is kept
    when its hash is at or above it (JAX common.py:142)."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def dropout_keep_mask(seed, salt, rows, cols, dropout_p: float):
    """Counter-based keep mask (True = keep), keyed on global positions,
    bit for bit the JAX package's (common.py:120-144): a Weyl-sequence mix
    of (row, col, seed ^ salt * C) and a Murmur3-style finalizer, all in
    uint32, emulated here in int64 with every product reduced to 32 bits.
    seed, salt: ints or int tensors (any sign: their low 32 bits, as
    JAX's int32 -> uint32 cast); rows, cols: int tensors of global row and
    column ids, broadcast against each other and the salt."""
    dev = rows.device if isinstance(rows, torch.Tensor) else None
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev) & _U32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=dev) & _U32
    rows = torch.as_tensor(rows, device=dev).long() & _U32
    cols = torch.as_tensor(cols, device=dev).long() & _U32
    x = (_mul_u32(rows, DROP_ROW) + _mul_u32(cols, DROP_COL)
         + (seed ^ _mul_u32(salt, DROP_SALT))).bitwise_and_(_U32)
    for shift, mix in ((16, DROP_MIX1), (15, DROP_MIX2)):
        x ^= x >> shift
        x = _mul_u32(x, mix)
    x ^= x >> 16
    return x >= dropout_threshold(dropout_p)


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Attention dropout as the kernels and their plain versions take it:
    rate ``p`` (0 < p < 1) and the seed's low 32 bits. The mask of query
    head ``head`` of batch row ``batch`` (h query heads) has salt batch *
    h + head, so every head of a GQA group has its own (JAX
    fwd.py:323-326); rows and columns are the positions in the (b, h, s,
    d) tensors (the packed positions under varlen). Kept elements of P are
    scaled by 1 / (1 - p): the kernels fold it into the output's (dV's)
    epilogue and into dP."""

    p: float
    seed: int

    @staticmethod
    def make(dropout_p: float, dropout_seed) -> Optional[Dropout]:
        """None for ``dropout_p`` <= 0; ``ValueError`` without a seed (as
        the JAX package's interface.py:173-174). ``dropout_seed``: an int
        or a one-element int tensor (read on the host)."""
        if dropout_p <= 0.0:
            return None
        if dropout_seed is None:
            raise ValueError("dropout_p > 0 requires dropout_seed")
        return Dropout(float(dropout_p), int(dropout_seed) & _U32)

    @property
    def threshold(self) -> int:
        return dropout_threshold(self.p)

    @property
    def scale(self) -> float:
        return 1.0 / (1.0 - self.p)

    def keep(self, b: int, h: int, sq: int, sk: int, device=None):
        """The (b, h, sq, sk) keep mask of every (batch, query head)."""
        salt = (torch.arange(b, device=device)[:, None] * h
                + torch.arange(h, device=device)[None, :])
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
        return dropout_keep_mask(self.seed, salt[..., None, None], rows,
                                 cols, self.p)

    @staticmethod
    def c_args(drop: Optional[Dropout]) -> tuple:
        """XFA_DROPOUT_ARGS of csrc/common.cuh: on, seed, threshold, scale
        (all 0 without dropout)."""
        if drop is None:
            return 0, 0, 0, 0.0
        return 1, drop.seed, drop.threshold, drop.scale


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


# ------------------------------------ windows, segment ids and positions

# Positions past a sequence's end (JAX common.py:286 POS_PAD): their stats
# read as "never attended / attends nothing real".
POS_PAD = 2 ** 30
# Window bounds are capped here so that position +- window stays inside
# int32 in the kernels (positions are expected within +-2**29).
WINDOW_CAP = 2 ** 29
# Segment ids, positions and their stats are padded to a multiple of this
# many tokens per batch row, so that no kernel tile's TMA box crosses into
# the next batch row.
TOKEN_PAD = 128


def resolve_window(causal: bool, window_size, sq: int, sk: int,
                   positions: bool):
    """(causal, window, pos_window) as the kernels take them.

    ``causal`` sets the right bound to 0 (JAX fwd.py:596). With
    ``positions`` the bounds apply to the position values and the row/key
    window is off (JAX fwd.py:602-610). Without, bounds that cut no pair
    are dropped (a left bound >= sk - 1, a right bound >= sq - 1 of a
    non-causal window), and a window of right bound 0 alone is causal.
    Returns the plain causal flag, the row/key window (left, right) and
    the position window, each bound -1 when absent.
    """
    left, right = (min(int(w), WINDOW_CAP) if w >= 0 else -1
                   for w in window_size)
    if causal:
        right = 0
    if positions:
        return False, (-1, -1), (left, right)
    if left >= max(sk - 1, 0):
        left = -1
    if right > 0 and right >= sq - 1:
        right = -1
    if left < 0 and right in (-1, 0):
        return right == 0, (-1, -1), (-1, -1)
    return False, (left, right), (-1, -1)


def check_tokens(name: str, ids, b: int, s: int) -> None:
    if ids is not None and (ids.dim() != 2 or tuple(ids.shape) != (b, s)):
        raise ValueError(f"{name} must be ({b}, {s}), got {tuple(ids.shape)}")


def window_keep(sq: int, sk: int, window, device=None) -> torch.Tensor:
    """Dense keep mask (1, 1, sq, sk) of a row/key window (left, right),
    bottom-right aligned; -1: no bound."""
    left, right = window
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=device)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if right >= 0:
        keep &= cols <= rows + right
    if left >= 0:
        keep &= cols >= rows - left
    return keep[None, None]


def token_keep(q_segment_ids=None, kv_segment_ids=None, q_positions=None,
               kv_positions=None, pos_window=(-1, -1)):
    """Dense keep mask (b, 1, sq, sk) of segment ids (equal ids attend) and
    of a window on positions (kpos <= qpos + right, kpos >= qpos - left),
    or None when neither is given."""
    keep = None
    if q_segment_ids is not None:
        keep = (q_segment_ids[:, None, :, None]
                == kv_segment_ids[:, None, None, :])
    if q_positions is not None and pos_window != (-1, -1):
        qp = q_positions[:, None, :, None].to(torch.int64)
        kp = kv_positions[:, None, None, :].to(torch.int64)
        pk = torch.ones_like(qp == kp)
        if pos_window[1] >= 0:
            pk = pk & (kp <= qp + pos_window[1])
        if pos_window[0] >= 0:
            pk = pk & (kp >= qp - pos_window[0])
        keep = pk if keep is None else keep & pk
    return keep


def _and_masks(keep, other, h: int):
    if other is None:
        return keep
    if keep is None:
        return other
    if 1 not in (keep.shape[1], other.shape[1]):
        keep, other = expand_heads(keep, h), expand_heads(other, h)
    return keep & other


def dense_keep_mask(sq: int, sk: int, h: int, *, flashmask_vecs=None,
                    flashmask_mode=None, block_mask=None, window=(-1, -1),
                    q_segment_ids=None, kv_segment_ids=None,
                    q_positions=None, kv_positions=None,
                    pos_window=(-1, -1), device=None):
    """The keep mask (b|1, hm|1, sq, sk) of the FlashMask, block-mask,
    row/key window, segment and position flags together (the plain causal
    flag apart), or None when none is given; on the flags' device, or
    ``device`` for a window alone."""
    keep = None
    if flashmask_vecs is not None:
        keep = fm_keep_mask(flashmask_vecs, flashmask_mode, sq)
    if block_mask is not None:
        keep = _and_masks(keep, block_keep_mask(*block_mask, sq, sk), h)
    device = next((t.device for t in (flashmask_vecs, q_segment_ids,
                                      q_positions) if t is not None), device)
    if device is None and block_mask is not None:
        device = block_mask[0].device
    if tuple(window) != (-1, -1):
        keep = _and_masks(keep, window_keep(sq, sk, window, device), h)
    return _and_masks(keep, token_keep(q_segment_ids, kv_segment_ids,
                                       q_positions, kv_positions,
                                       tuple(pos_window)), h)


def token_pairs(segment_ids, positions, b: int, s: int, device):
    """(info, src): per token (segment id, position, 0, 0) int32, (b,
    round_up(s, TOKEN_PAD), 4) contiguous, 0 where absent and in the
    padding (the rows the kernels load by TMA with a tile or a block); and
    (b, round_up(s, TOKEN_PAD), 2), the pairs padded as the JAX package
    pads them for its stats (the last segment id, positions POS_PAD),
    the source of :func:`token_stats`."""
    sp = round_up(max(s, 1), TOKEN_PAD)
    zero = torch.zeros(b, s, dtype=torch.int32, device=device)
    pair = torch.stack([zero if x is None else x.to(torch.int32)
                        for x in (segment_ids, positions)], -1)
    info = torch.nn.functional.pad(pair, (0, 2, 0, sp - s)).contiguous()
    if sp == s:
        return info, pair
    tail = pair[:, -1:].clone()
    if positions is not None:
        tail[..., 1] = POS_PAD
    return info, torch.cat([pair, tail.expand(b, sp - s, 2)], 1)


def token_stats(src: torch.Tensor, s: int, block: int) -> torch.Tensor:
    """Per tile of ``block`` tokens [segment min, max, position min, max],
    (b, ceil(s / block), 4) int32 contiguous, from :func:`token_pairs`'
    ``src`` (JAX common.py:286 pos_pad_and_stats, :306 seg_block_stats)."""
    b, sp, _ = src.shape
    r = src.reshape(b, sp // block, block, 2)
    lo, hi = r.amin(2), r.amax(2)
    st = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    return st[:, :cdiv(max(s, 1), block)].contiguous()


def pair_visible(qst, kst, pos_window):
    """(b, nq, nk) bool: the query tiles with stats ``qst`` (b, nq, 4) and
    the key tiles with ``kst`` (b, nk, 4) that may hold a visible pair:
    overlapping segment ranges and position ranges that meet the position
    window (the kernels' skip test, csrc/common.cuh token_flags)."""
    q, k = qst[:, :, None, :], kst[:, None, :, :]  # int32: no sum overflows
    vis = (q[..., 0] <= k[..., 1]) & (k[..., 0] <= q[..., 1])
    if pos_window[1] >= 0:
        vis &= k[..., 2] <= q[..., 3] + pos_window[1]
    if pos_window[0] >= 0:
        vis &= k[..., 3] >= q[..., 2] - pos_window[0]
    return vis


def tile_ranges(vis: torch.Tensor) -> torch.Tensor:
    """For (b, n, m) bool ``vis``: per (batch, block) the tiles [lo, hi)
    from the first to the last visible one, (0, 0) when none, (b, n, 2)
    int32 contiguous; computed on the device, nothing read back."""
    m = vis.shape[-1]
    idx = torch.arange(m, device=vis.device)
    lo = torch.where(vis, idx, m).amin(-1)
    hi = torch.where(vis, idx + 1, 0).amax(-1)
    lo = torch.where(hi > 0, lo, 0)
    return torch.stack([lo, hi], -1).to(torch.int32).contiguous()


def kernel_tiles(kind: str, d: int):
    """(query rows, keys) of the tiles of masked kernel ``kind`` at head
    dim ``d``, at which it reads the stats: the bf16 kernels "fwd", "dkv",
    "dq" (csrc/flash_fwd.cu, flash_bwd.cu; dQ's keys depend on the head
    dim, bwd.py bwd_dq_tile_n) and the fp32 kernels "fwd_fp32", "dkv_fp32",
    "dq_fp32" (csrc/flash_fp32.cu: the forward's key tiles of 64 keys at d
    64 and 32 at d 128; dK/dV's query tiles of 32 rows against key blocks
    of 128 keys at d 64, 16 against 64 at d 128; dQ's key tiles of 32 keys
    at d 64 and 16 at d 128; the forward's and dQ's blocks 128 rows). "dkv"
    kinds stream query tiles per key block, the others key tiles per query
    block."""
    tiles = {
        "fwd": (128, 128), "dkv": (64, 128), "dq": (128, 128 if d == 64 else 64),
        "fwd_fp32": (128, 64 if d == 64 else 32),
        "dkv_fp32": (32, 128) if d == 64 else (16, 64),
        "dq_fp32": (128, 32 if d == 64 else 16),
    }
    return tiles[kind]


class KernelMasks:
    """The mask flags as the CUDA kernels take them (the ``MaskParams`` of
    csrc/common.cuh): FlashMask int32 vectors padded to a multiple of
    FM_PAD_KEYS keys, per key tile stats made once per tile size (the
    forward and dK/dV share those of 128 keys), the bands the kernels test
    elementwise (:func:`fm_bands`) made once, the int32 block mask at its
    own granularity with its batch and head strides (0 where it
    broadcasts); the row/key window and the position window (from
    :func:`resolve_window`); the segment ids and positions per token
    (:func:`token_pairs`), their stats per kernel tile and the tile ranges
    per block, made once per kernel tile size. ``active`` is False when no
    flag is set: the dense kernels run."""

    def __init__(self, b: int, h: int, sq: int, sk: int, *,
                 flashmask_vecs=None, flashmask_mode=None, block_mask=None,
                 window=(-1, -1), q_segment_ids=None, kv_segment_ids=None,
                 q_positions=None, kv_positions=None, pos_window=(-1, -1)):
        self.fm_vecs = self.bm = self._bands = self._token_pairs = None
        self._stats = {}
        self._tok = {}
        self.b, self.sq, self.sk = b, sq, sk
        self.window, self.pos_window = tuple(window), tuple(pos_window)
        self._keep_kw = dict(
            flashmask_vecs=flashmask_vecs, flashmask_mode=flashmask_mode,
            block_mask=block_mask, window=self.window,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions,
            pos_window=self.pos_window)
        if (q_segment_ids is None) != (kv_segment_ids is None):
            raise ValueError("pass q_segment_ids and kv_segment_ids together")
        if (q_positions is None) != (kv_positions is None):
            raise ValueError("pass q_positions and kv_positions together")
        for name, ids, s in (("q_segment_ids", q_segment_ids, sq),
                             ("kv_segment_ids", kv_segment_ids, sk),
                             ("q_positions", q_positions, sq),
                             ("kv_positions", kv_positions, sk)):
            check_tokens(name, ids, b, s)
        self.seg = (None if q_segment_ids is None else
                    (q_segment_ids, kv_segment_ids))
        self.pos = (None if q_positions is None else
                    (q_positions, kv_positions))
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

    def keep(self, h: int, device=None):
        """The dense keep mask of every flag (:func:`dense_keep_mask`), the
        plain versions' mask, or None; a window alone on ``device``."""
        return dense_keep_mask(self.sq, self.sk, h, **self._keep_kw,
                               device=device)

    @property
    def has_tokens(self) -> bool:
        return self.seg is not None or self.pos is not None

    @property
    def active(self) -> bool:
        return bool(self.tensors()) or self.window != (-1, -1)

    def tensors(self):
        ts = [t for t in (self.fm_vecs, self.bm) if t is not None]
        for pair in (self.seg, self.pos):
            if pair is not None:
                ts += list(pair)
        return ts

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

    def _side(self, i: int):
        seg = self.seg[i] if self.seg is not None else None
        pos = self.pos[i] if self.pos is not None else None
        return seg, pos, (self.sq, self.sk)[i]

    def _same_sides(self) -> bool:
        """The queries' segment ids and positions are the keys' (one
        packing, self-attention): each is made once for both."""
        return self.sq == self.sk and all(
            pair is None or pair[0] is pair[1] for pair in (self.seg, self.pos))

    def _pairs(self):
        """:func:`token_pairs` of the queries and of the keys, made once."""
        if self._token_pairs is None:
            dev = self.tensors()[-1].device
            q = token_pairs(*self._side(0)[:2], self.b, self.sq, dev)
            self._token_pairs = [q, q if self._same_sides() else token_pairs(
                *self._side(1)[:2], self.b, self.sk, dev)]
        return self._token_pairs

    def info(self):
        """(q_info, kv_info), each (b, round_up(s, TOKEN_PAD), 4), or None
        without segment ids and positions."""
        if not self.has_tokens:
            return None
        return tuple(info for info, _ in self._pairs())

    def tok_stats(self, side: int, block: int) -> torch.Tensor:
        """Stats per tile of ``block`` queries (side 0) or keys (1)."""
        key = (0 if self._same_sides() else side, block)
        if key not in self._tok:
            self._tok[key] = token_stats(self._pairs()[side][1],
                                         self._side(side)[2], block)
        return self._tok[key]

    def ranges(self, kind: str, d: int) -> torch.Tensor:
        """The tile ranges [lo, hi) per block of kernel ``kind``
        (:func:`kernel_tiles`): per query block over key tiles, or for the
        "dkv" kinds per key block over query tiles (:func:`tile_ranges`);
        kernels with the same tiles share them."""
        rows, keys = kernel_tiles(kind, d)
        per_key = kind.startswith("dkv")
        key = ("range", rows, keys, per_key)
        if key not in self._tok:
            vis = pair_visible(self.tok_stats(0, rows),
                               self.tok_stats(1, keys), self.pos_window)
            self._tok[key] = tile_ranges(vis.transpose(1, 2) if per_key
                                         else vis)
        return self._tok[key]

    @staticmethod
    def c_args(masks, causal: bool, kind: str, d: int) -> tuple:
        """The trailing mask arguments of the C entry point of kernel
        ``kind`` (:func:`kernel_tiles`) at head dim ``d`` (XFA_MASK_ARGS):
        the FlashMask stats, segment / position stats and tile ranges at
        its tiles (:func:`kernel_tiles`). ``causal`` sets the right bound
        of the masked kernels' window to 0."""
        rows, keys = kernel_tiles(kind, d)
        fm = (None, None, 0, 1, 0)
        bm = (None, 0, 0, 1, 0, 1, 1)
        win = (-1, -1, -1, -1)
        tok = (None,) * 5 + (0,) * 5
        if masks is not None and masks.fm_vecs is not None:
            v = masks.fm_vecs
            fm = (v.data_ptr(), masks.stats(keys).data_ptr(),
                  FM_CODES[masks.fm_mode], v.shape[1], v.shape[3])
        if masks is not None and masks.bm is not None:
            m = masks.bm
            bm = (m.data_ptr(), masks.bm_sb, masks.bm_sh, m.shape[1],
                  m.shape[3], masks.gq, masks.gk)
        if masks is not None and masks.active:
            left, right = masks.window
            win = (left, 0 if causal else right) + masks.pos_window
        if masks is not None and masks.has_tokens:
            qi, ki = masks.info()
            qst, kst = masks.tok_stats(0, rows), masks.tok_stats(1, keys)
            rng = masks.ranges(kind, d)
            tok = (qi.data_ptr(), ki.data_ptr(), qst.data_ptr(),
                   kst.data_ptr(), rng.data_ptr(), qi.shape[1], ki.shape[1],
                   qst.shape[1], kst.shape[1], rng.shape[1])
        return fm + bm + win + tok
