"""The launch plan of csrc/paged_decode.cu, mirrored in plain Python
(inference/paged.py), against the keys each row of a sequence sees.

Row r = si * g + gi of a sequence of ``length`` keys (the sq new tokens
included) sees keys j with j <= pos = length - sq + si, j < cap and, with a
window, j >= pos - window_left. For ragged lengths (0 and the capacity
among them), sq of 1, 3, 37 and 512, g of 1 and 4, windows, page sizes 16,
64, 512 and 4096 and every cluster size:

* decode regime (sq * g <= 16): the CTAs' key runs are tile-aligned and
  disjoint, and together they cover exactly the keys some row sees (keys
  before the first visible one in its tile are read as zeros);
* prefill regime: each row block's plan visits every key tile that holds a
  visible (row, key) pair of the block once, no other tile, from the last
  to the first, and leaves the mask off exactly the tiles that every row of
  the block sees whole.

No JAX: these are shapes and integers only.
"""

import numpy as np
import pytest

from xhy_flash_attention_tpu_torch.inference import paged
from xhy_flash_attention_tpu_torch.ops.flash_attention.decode_kernel import (
    CLUSTER_SIZES,
    MAX_ROWS,
    TILE,
)

PAGE_SIZES = {16: 32, 64: 8, 512: 8, 4096: 1}  # page size -> pages per sequence
WINDOWS = (-1, 0, 7, 200)


def _lengths(sq, cap):
    return sorted({n for n in (0, 1, sq, 63, 64, 65, cap // 2 + 3, cap - 1, cap)
                   if n <= cap})


def _row_keys(length, sq, g, cap, window, rows):
    """Inclusive key range [a, b] of each row (a > b: the row sees nothing)."""
    pos = length - sq + np.asarray(rows) // g
    b = np.minimum(pos, cap - 1)
    a = np.maximum(0, pos - window) if window >= 0 else np.zeros_like(pos)
    return a, b


@pytest.mark.parametrize("ps", sorted(PAGE_SIZES))
@pytest.mark.parametrize("sq,g", [(1, 1), (1, 4), (3, 1), (3, 4)])
def test_decode_runs_cover_the_visible_keys(sq, g, ps):
    cap = ps * PAGE_SIZES[ps]
    assert sq * g <= MAX_ROWS
    for length in _lengths(sq, cap):
        for window in WINDOWS:
            a, b = _row_keys(length, sq, g, cap, window, range(sq * g))
            seen = {j for lo, hi in zip(a, b) for j in range(lo, hi + 1)}
            for cluster in CLUSTER_SIZES:
                runs = paged.decode_cta_runs(length, sq, window, cap, cluster)
                assert len(runs) == cluster
                read = []
                for lo, hi in runs:
                    assert lo <= hi
                    if lo < hi:
                        assert lo % TILE == 0  # tile-aligned starts
                    read += range(lo, hi)
                assert len(read) == len(set(read))  # disjoint
                assert all(r0[1] <= r1[0] for r0, r1 in zip(runs, runs[1:])
                           if r0[0] < r0[1] and r1[0] < r1[1])
                # every visible key read; the others only as padding before
                # the first visible key of its tile
                assert seen <= set(read)
                extra = set(read) - seen
                if seen:
                    first = min(seen)
                    assert all(first // TILE * TILE <= j < first for j in extra)
                else:
                    assert not extra


@pytest.mark.parametrize("ps", sorted(PAGE_SIZES))
@pytest.mark.parametrize("sq,g", [(37, 1), (37, 4), (512, 1), (512, 4)])
def test_prefill_plan_visits_each_visible_tile_once(sq, g, ps):
    cap = ps * PAGE_SIZES[ps]
    rows = sq * g
    assert rows > MAX_ROWS
    n = paged.PREFILL_TILE_N
    for length in _lengths(sq, cap):
        for window in WINDOWS:
            for m_block in range(-(-rows // paged.PREFILL_TILE_M)):
                r0 = m_block * paged.PREFILL_TILE_M
                block = np.arange(r0, min(r0 + paged.PREFILL_TILE_M, rows))
                a, b = _row_keys(length, sq, g, cap, window, block)
                plan = paged.prefill_tile_plan(length, sq, g, cap, window,
                                               m_block)
                n0s = [n0 for n0, _ in plan]
                assert n0s == sorted(set(n0s), reverse=True)  # last to first, once
                tiles = np.arange(0, cap, n)[:, None]          # (tiles, 1)
                any_seen = ((a <= tiles + n - 1) & (b >= tiles) & (a <= b)).any(1)
                whole = ((a <= tiles) & (b >= tiles + n - 1)).all(1)
                assert set(n0s) == set(tiles[any_seen, 0].tolist())
                for n0, masked in plan:
                    assert masked == (not whole[n0 // n])


@pytest.mark.parametrize("rows_per_head", [MAX_ROWS, MAX_ROWS + 1])
def test_regime_boundary(rows_per_head):
    """sq * h / hk rows per KV head: up to 16 the decode regime on clusters,
    past it the prefill regime, one CTA per 128 rows per (batch, kv head)."""
    plan = paged.paged_launch_plan(8, rows_per_head, 8, 8, 512, 8, 132)
    if rows_per_head <= MAX_ROWS:
        assert plan["regime"] == "decode"
        assert plan["ctas"] == plan["cluster"] * 64
    else:
        assert plan["regime"] == "prefill"
        assert plan["ctas"] == 64 and plan["tma_pages"]


@pytest.mark.parametrize("b,hk,cap,sms,cluster", [
    (8, 8, 4096, 132, 8),   # the engine's decode step: 512 CTAs
    (2, 8, 2080, 132, 8),   # request A's shape
    (1, 1, 64, 132, 1),     # one tile: nothing to split
    (32, 8, 4096, 132, 2),  # 512 CTAs: two waves of two an SM
    (64, 8, 4096, 132, 1),  # the grid alone fills two waves
])
def test_cluster_plan_reads_shapes_only(b, hk, cap, sms, cluster):
    """The cluster size comes from the capacity, b * hk and the SM count
    (never from lengths, so the call can be captured in a CUDA graph): the
    largest that keeps the grid within two waves of two CTAs an SM; a
    forced size is kept."""
    plan = paged.paged_launch_plan(b, 1, 4 * hk, hk, cap, 1, sms)
    assert (plan["regime"], plan["cluster"]) == ("decode", cluster)
    for forced in CLUSTER_SIZES:
        plan = paged.paged_launch_plan(b, 1, 4 * hk, hk, cap, 1, sms, forced)
        assert plan["cluster"] == forced
        assert plan["chunk"] * forced >= cap
