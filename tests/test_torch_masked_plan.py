"""What the masked attention kernels visit, in pure Python.

``bwd_masked_dkv_tile_plan``, ``bwd_masked_dq_tile_plan`` and
``fwd_masked_tile_plan`` mirror the producers of the masked instantiations
of csrc/flash_bwd.cu and csrc/flash_fwd.cu: from the FlashMask stats at the
kernels' tiles (128 keys for the forward and dK/dV, 128 or 64 for dQ) and
the block-mask entries, the tiles each block visits, in order, with their
elementwise flag and the parts each consumer computes. Held against the
dense keep mask (the causal part included): every visible (row, key) pair
lies in a visited part of a tile, a tile without the flag holds no masked
in-range pair in the parts it computes, and a skipped tile or part holds no
visible pair; tiles that need the elementwise test come first within a
head. Cases: the four FlashMask modes with one mask head and one per head,
GQA, a causal document mask (causal_1: the dK/dV query loop ends at the
block's largest LTStart), block masks at granularities 64 (straddling the
128-key and 128-row blocks and tiles), 128 and 256, s 200 (ragged), causal
with sq != sk. Also the stats and the skip/bypass decisions against the JAX
package's ``fm_block_stats`` and ``fm_skip_bypass`` on the same seeded
vectors, exactly. The same checks under sliding windows (causal with a
left bound, left only, right only, both, sq != sk), segment ids (sorted
and arbitrary, padded tails), q/kv positions (varlen packings with
cu_seqlens_q != cu_seqlens_k) and their combinations with FlashMask and
block masks; the producers consider only the window's key tiles and the
tiles the segment and position stats allow; the segment and position
stats against the JAX package's ``seg_block_stats`` and
``pos_pad_and_stats``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import common as jcommon
from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common, fwd
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    causal_document_mask,
)

MODES = [(True, 1), (True, 2), (False, 2), (False, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(rng, causal, nv, b, hm, sk):
    """Random valid FlashMask vectors (b, hm, NV, sk), as
    tests/test_flashmask.py draws them."""
    lts = rng.integers(0, sk + 1, (b, hm, 1, sk))
    if causal and nv == 1:
        vecs = [lts]
    elif causal:
        vecs = [lts, np.minimum(lts + rng.integers(0, sk, lts.shape), sk)]
    elif nv == 2:
        vecs = [lts, rng.integers(0, lts + 1)]
    else:
        uts = rng.integers(0, sk + 1, lts.shape)
        vecs = [lts, np.minimum(lts + rng.integers(0, sk // 2, lts.shape), sk),
                uts, np.minimum(uts + rng.integers(0, sk // 2, lts.shape), sk)]
    return np.concatenate(vecs, 2).astype(np.int32)


def _visible(flags, b, h, sq, sk, causal):
    """(b, h, sq, sk) bool: the pairs attended, the causal part included."""
    keep = common.dense_keep_mask(sq, sk, h, **flags)
    keep = common.expand_heads(keep, h).expand(b, h, sq, sk)
    if causal:
        rows, cols = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        keep = keep & (cols <= rows + (sk - sq))
    return keep


def _check_part(vis, rows, keys, visited, elementwise):
    """One part of a tile: rows x keys (in range) of one head."""
    block = vis[rows[0]:rows[1], keys[0]:keys[1]]
    if block.numel() == 0:
        return 0
    if not visited:
        assert not block.any(), "a skipped part holds a visible pair"
    elif not elementwise:
        assert block.all(), "a part without the elementwise test is masked"
    return int(visited)


def check_dkv_plan(flags, b, h, hk, sq, sk, causal):
    masks = common.KernelMasks(b, h, sq, sk, **flags)
    plan = bwd.bwd_masked_dkv_tile_plan(masks, b, h, hk, sq, sk, causal)
    vis = _visible(flags, b, h, sq, sk, causal)
    return plan, _check_dkv(plan, vis, h, hk, sq, sk)


def _check_dkv(plan, vis, h, hk, sq, sk, m=bwd.BWD_DKV_TILE_M,
               n=bwd.BWD_DKV_TILE_N):
    """A dK/dV plan over key blocks of ``n`` keys and query tiles of ``m``
    rows: each consumer's 64 keys (a block of 64 keys: both consumers take
    it, its two parts the same)."""
    g = h // hk
    n_qt, visited = -(-sq // m), 0
    for (batch, kv_head, nb), tiles in plan.items():
        n0 = nb * n
        seen = {(gi, t): (e, parts) for gi, t, e, parts in tiles}
        assert len(seen) == len(tiles), "a tile visited twice"
        heads = [gi for gi, *_ in tiles]
        assert heads == sorted(heads), "the group's heads out of order"
        for gi in range(g):
            flagged = [e for hi, _, e, _ in tiles if hi == gi]
            assert flagged == sorted(flagged, reverse=True), \
                "an elementwise tile after a free one"
            for t in range(n_qt):
                e, parts = seen.get((gi, t), (False, (False, False)))
                if n == 64:
                    assert parts[0] == parts[1]
                for c in (0, 1) if n == 128 else (0,):
                    visited += _check_part(
                        vis[batch, kv_head * g + gi],
                        (t * m, min(t * m + m, sq)),
                        (n0 + 64 * c, min(n0 + 64 * c + 64, sk)),
                        parts[c], e)
    return visited


def _check_row_block_plan(plan, vis, sq, sk, n):
    """A plan over blocks of 128 query rows and key tiles of ``n`` keys
    (the forward's, or dQ's): each consumer's 64 rows against the tile's
    64-key parts (a tile of 64 keys or fewer: one part, both the same)."""
    m, visited = 128, 0
    for (batch, head, mb), tiles in plan.items():
        q0 = mb * m
        seen = {t: (e, parts) for t, e, parts in tiles}
        assert len(seen) == len(tiles), "a tile visited twice"
        flagged = [e for _, e, _ in tiles]
        assert flagged == sorted(flagged, reverse=True), \
            "an elementwise tile after a free one"
        for t in range(-(-sk // n)):
            e, parts = seen.get(t, (False, ((False,) * 2,) * 2))
            if not e:
                assert all(a == c for a, c in parts), \
                    "straddling parts without the elementwise test"
            for c in (0, 1):
                width = min(n, 64)
                for j in range(max(1, n // 64)):
                    visited += _check_part(
                        vis[batch, head], (q0 + 64 * c, min(q0 + 64 * c + 64, sq)),
                        (t * n + width * j, min(t * n + width * j + width, sk)),
                        parts[c][j], e)
                if n <= 64:
                    assert parts[c][0] == parts[c][1]
    return visited


def check_dq_plan(flags, b, h, hk, sq, sk, causal, d):
    masks = common.KernelMasks(b, h, sq, sk, **flags)
    plan = bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, sq, sk, causal, d)
    assert bwd.BWD_DQ_TILE_M == 128
    vis = _visible(flags, b, h, sq, sk, causal)
    return plan, _check_row_block_plan(plan, vis, sq, sk,
                                       bwd.bwd_dq_tile_n(d))


def check_fwd_plan(flags, b, h, sq, sk, causal):
    """The masked forward's plan: blocks of 128 rows over 128-key tiles,
    the candidates those of the dense forward's plan."""
    masks = common.KernelMasks(b, h, sq, sk, **flags)
    plan = fwd.fwd_masked_tile_plan(masks, b, h, sq, sk, causal)
    assert (fwd.FWD_DENSE_TILE_M, fwd.FWD_DENSE_TILE_N) == (128, 128)
    cands = fwd.fwd_tile_plan(sq, sk, causal)
    for (_, _, mb), tiles in plan.items():
        assert {t for t, _, _ in tiles} <= {t for t, _ in cands[mb]}
    vis = _visible(flags, b, h, sq, sk, causal)
    return plan, _check_row_block_plan(plan, vis, sq, sk, 128)


def _fm_flags(seed, causal, nv, b, hm, sk):
    vecs = torch.from_numpy(_bands(np.random.default_rng(seed), causal, nv, b,
                                   hm, sk))
    return dict(flashmask_vecs=vecs, flashmask_mode=common.fm_mode_for(causal,
                                                                       nv))


@pytest.mark.parametrize("hm", [1, 4])
@pytest.mark.parametrize("causal,nv", MODES)
@pytest.mark.parametrize("s", [200, 256])
def test_masked_plans_cover_flashmask(causal, nv, hm, s):
    """Every mode, one mask head or one per head, GQA (h 4 over hk 2), a
    ragged and a whole length, both head dims' dQ tiles."""
    b, h, hk = 2, 4, 2
    flags = _fm_flags(s + 7 * nv + hm + int(causal), causal, nv, b, hm, s)
    _, vis_kv = check_dkv_plan(flags, b, h, hk, s, s, causal)
    assert vis_kv > 0
    for d in (64, 128):
        check_dq_plan(flags, b, h, hk, s, s, causal, d)
    _, vis_fwd = check_fwd_plan(flags, b, h, s, s, causal)
    assert vis_fwd > 0


def test_causal_1_ends_at_the_largest_ltstart():
    """A causal document mask (causal_1): each key block's query tiles end
    at the largest LTStart of its keys, and the plans skip work."""
    b, h, hk, s = 2, 2, 1, 512
    doc = torch.tensor([[0] * 100 + [1] * 150 + [2] * 262,
                        [0] * 300 + [1] * 212])
    idx = causal_document_mask(doc)
    flags = dict(flashmask_vecs=idx.movedim(-1, 2),
                 flashmask_mode="causal_1")
    plan, _ = check_dkv_plan(flags, b, h, hk, s, s, True)
    lts = flags["flashmask_vecs"][:, 0, 0]
    for (batch, _, nb), tiles in plan.items():
        end = int(lts[batch, nb * 128:(nb + 1) * 128].max())
        assert tiles and max(t for _, t, _, _ in tiles) < -(-end // 64)
    dense = sum(len(c) for c in bwd.bwd_dkv_tile_plan(s, s, True)) * b * h
    assert sum(map(len, plan.values())) < dense
    check_dq_plan(flags, b, h, hk, s, s, True, 64)
    fwd_plan, _ = check_fwd_plan(flags, b, h, s, s, True)
    dense = sum(len(c) for c in fwd.fwd_tile_plan(s, s, True)) * b * h
    assert sum(map(len, fwd_plan.values())) < dense


@pytest.mark.parametrize("gq,gk", [(64, 64), (64, 128), (128, 64),
                                   (128, 128), (256, 256)])
@pytest.mark.parametrize("hm", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_masked_plans_cover_block_masks(gq, gk, hm, causal):
    """Block masks at granularities that the 128-key and 128-row blocks
    straddle (64) or that cover them, broadcast over batch (b 1 in the
    mask) or per batch element, s 300 (ragged)."""
    b, h, hk, s = 2, 4, 2, 300
    rng = np.random.default_rng(gq + gk + hm + int(causal))
    mb = 1 if hm == 1 else b
    mask = torch.from_numpy(
        (rng.random((mb, hm, -(-s // gq), -(-s // gk))) < 0.5).astype(np.int32))
    flags = dict(block_mask=(mask, gq, gk))
    plan, vis_kv = check_dkv_plan(flags, b, h, hk, s, s, causal)
    assert vis_kv > 0
    halves = [parts for tiles in plan.values() for *_, parts in tiles]
    if gk == 64:  # some block has one consumer's keys off, the other's on
        assert any(a != c for a, c in halves)
    for d in (64, 128):
        dq_plan, _ = check_dq_plan(flags, b, h, hk, s, s, causal, d)
        if gk == 64 and d == 64:
            assert any(a != c for tiles in dq_plan.values()
                       for _, _, parts in tiles for a, c in parts)
    fwd_plan, _ = check_fwd_plan(flags, b, h, s, s, causal)
    if gk == 64:  # a 128-key tile whose two 64-key parts differ
        assert any(a != c for tiles in fwd_plan.values()
                   for _, _, parts in tiles for a, c in parts)


@pytest.mark.parametrize("sq,sk", [(150, 300), (300, 150), (200, 200)])
def test_masked_plans_cover_causal_sq_ne_sk(sq, sk):
    """Causal with sq != sk (the diagonal aligned bottom right) under a
    FlashMask and a block mask together."""
    b, h, hk = 1, 2, 1
    flags = _fm_flags(sq + sk, True, 2, b, 1, sk)
    rng = np.random.default_rng(sq)
    flags["block_mask"] = (torch.from_numpy(
        (rng.random((1, 1, -(-sq // 64), -(-sk // 128))) < 0.7)
        .astype(np.int32)), 64, 128)
    check_dkv_plan(flags, b, h, hk, sq, sk, True)
    for d in (64, 128):
        check_dq_plan(flags, b, h, hk, sq, sk, True, d)
    check_fwd_plan(flags, b, h, sq, sk, True)


def test_plans_without_a_mask_are_the_dense_plans():
    """No mask: every candidate is visited, in the dense kernels' order."""
    masks = common.KernelMasks(1, 2, 300, 300)
    plan = bwd.bwd_masked_dkv_tile_plan(masks, 1, 2, 1, 300, 300, True)
    dense = bwd.bwd_dkv_tile_plan(300, 300, True)
    for (_, _, nb), tiles in plan.items():
        assert [(t, e) for gi, t, e, _ in tiles] == dense[nb] * 2
    plan = bwd.bwd_masked_dq_tile_plan(masks, 1, 2, 1, 300, 300, True, 64)
    dense = bwd.bwd_dq_tile_plan(300, 300, True, 64)
    for (_, _, mb), tiles in plan.items():
        assert [(t, e) for t, e, _ in tiles] == dense[mb]
    for causal in (False, True):
        plan = fwd.fwd_masked_tile_plan(masks, 1, 2, 300, 300, causal)
        dense = fwd.fwd_tile_plan(300, 300, causal)
        assert len(plan) == 2 * len(dense)
        for (_, _, mb), tiles in plan.items():
            assert [(t, e) for t, e, _ in tiles] == dense[mb]


@pytest.mark.parametrize("mask", ["flashmask", "block"])
def test_fwd_plan_is_the_dq_plan_at_d64(mask):
    """The masked forward and the masked dQ kernel at d 64 share their
    geometry (blocks of 128 rows, tiles of 128 keys, 128-key stats), so one
    mirror gives both the same tiles; a block row that a block mask turns
    off has no tile (its rows give O = 0 and LSE +inf)."""
    b, h, hk, s = 2, 4, 2, 330
    if mask == "flashmask":
        flags = _fm_flags(5, False, 4, b, 2, s)
        causal = False
    else:
        rng = np.random.default_rng(11)
        bm = (rng.random((b, 1, -(-s // 64), -(-s // 128))) < 0.6)
        bm[:, :, 2] = False  # rows 128-191: consumer 0 of block 1 sees nothing
        flags = dict(block_mask=(torch.from_numpy(bm.astype(np.int32)), 64,
                                 128))
        causal = True
    masks = common.KernelMasks(b, h, s, s, **flags)
    plan = fwd.fwd_masked_tile_plan(masks, b, h, s, s, causal)
    assert plan == bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, s, s, causal,
                                               64)
    check_fwd_plan(flags, b, h, s, s, causal)
    if mask == "block":
        assert all(not parts[0][0] and not parts[0][1]
                   for (_, _, mb), tiles in plan.items() if mb == 1
                   for _, _, parts in tiles)


@pytest.mark.parametrize("causal,nv", MODES)
@pytest.mark.parametrize("tile", [64, 128])
def test_stats_and_decisions_match_jax(causal, nv, tile):
    """KernelMasks' stats at the kernels' tiles equal the JAX package's
    fm_block_stats of the same vectors padded the same way, and the
    skip/bypass decisions equal its fm_skip_bypass for 64- and 128-row
    query tiles."""
    b, hm, sk = 2, 2, 330
    vecs = _bands(np.random.default_rng(tile + nv), causal, nv, b, hm, sk)
    mode = common.fm_mode_for(causal, nv)
    masks = common.KernelMasks(b, 2 * hm, sk, sk,
                               flashmask_vecs=torch.from_numpy(vecs),
                               flashmask_mode=mode)
    jpad = jcommon.fm_pad_vecs(jnp.asarray(vecs), mode, common.FM_PAD_KEYS)
    np.testing.assert_array_equal(masks.fm_vecs.numpy(), np.asarray(jpad))
    st = masks.stats(tile)
    jst = np.asarray(jcommon.fm_block_stats(jpad, tile)).reshape(st.shape)
    np.testing.assert_array_equal(st.numpy(), jst)
    for rows in (64, 128):
        for q0 in range(0, sk, rows):
            q1 = min(q0 + rows, sk)
            got = common.fm_skip_bypass(mode, lambda v, w: st[..., v, w],
                                        q0, q1)
            want = jcommon.fm_skip_bypass(
                mode, lambda v, w: jnp.asarray(jst)[..., v, w], q0, q1)
            for a, c in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("causal,nv", MODES)
def test_fm_bands_rewrite_every_mode(causal, nv):
    """The two bands each column carries to the backward kernels mask
    exactly the rows the mode's vectors mask, padded columns included."""
    b, hm, sk, sq = 1, 2, 150, 160
    vecs = torch.from_numpy(_bands(np.random.default_rng(nv), causal, nv, b,
                                   hm, sk))
    mode = common.fm_mode_for(causal, nv)
    padded = common.fm_pad_vecs(vecs, mode, common.FM_PAD_KEYS)
    bands = common.fm_bands(padded, mode)
    assert bands.shape == (b, hm, padded.shape[-1], 4)
    rows = torch.arange(sq)[:, None]
    lo1, hi1, lo2, hi2 = (bands[..., None, :, i] for i in range(4))
    masked = ((rows >= lo1) & (rows < hi1)) | ((rows >= lo2) & (rows < hi2))
    assert torch.equal(masked, common.fm_banned(mode, padded, rows))
    assert masked[..., sk:].all()


# ---- sliding windows, segment ids and positions

def check_flag_plans(b, h, hk, sq, sk, causal, window=(-1, -1), **flags):
    """Every masked kernel's mirror under the flags as the entry resolves
    them (fwd.build_masks), held to the dense keep mask of every flag:
    returns the (forward, dK/dV) plans."""
    eff, masks = fwd.build_masks(b, h, sq, sk, causal, window, **flags)
    keep = masks.keep(h)
    keep = (torch.ones(1, 1, sq, sk, dtype=torch.bool) if keep is None
            else common.expand_heads(keep, h))
    vis = keep.expand(b, h, sq, sk)
    if eff:
        rows, cols = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        vis = vis & (cols <= rows + (sk - sq))
    dkv = bwd.bwd_masked_dkv_tile_plan(masks, b, h, hk, sq, sk, eff)
    _check_dkv(dkv, vis, h, hk, sq, sk)
    for d in (64, 128):
        _check_row_block_plan(
            bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, sq, sk, eff, d),
            vis, sq, sk, bwd.bwd_dq_tile_n(d))
    plan = fwd.fwd_masked_tile_plan(masks, b, h, sq, sk, eff)
    _check_row_block_plan(plan, vis, sq, sk, 128)
    return plan, dkv


WINDOWS = [(True, (100, -1)), (False, (100, -1)), (False, (-1, 70)),
           (False, (130, 30)), (True, (0, 0))]


@pytest.mark.parametrize("causal,window", WINDOWS)
@pytest.mark.parametrize("sq,sk", [(300, 300), (200, 500), (500, 200)])
def test_masked_plans_cover_windows(sq, sk, causal, window):
    """Windows, with sq == sk, sq < sk and sq > sk (the card tests' cases):
    the visited tiles cover every visible pair, and the forward considers
    only the key tiles its rows' windows reach."""
    b, h, hk = 1, 2, 1
    plan, _ = check_flag_plans(b, h, hk, sq, sk, causal, window)
    eff, (left, right), _ = common.resolve_window(causal, window, sq, sk,
                                                  False)
    if left >= 0 and right >= 0:  # a window spans at most this many tiles
        most = -(-(left + right + 128) // 128) + 1
        assert max(map(len, plan.values())) <= most


def test_window_walks_only_its_tiles():
    """At s 8192 and window (4095, 0) (the Mistral-7B prefill) each block
    of 128 rows considers at most 33 key tiles, not the row's 64; the
    dK/dV blocks likewise at most 66 query tiles of 64 rows."""
    plans = fwd.key_window_plan(8192, 8192, 128, 128, (4095, 0))
    assert max(map(len, plans)) == 33
    assert sum(map(len, plans)) < 0.8 * sum(
        map(len, fwd.key_tile_plan(8192, 8192, True, 128, 128)))
    dkv = bwd.bwd_dkv_window_plan(8192, 8192, (4095, 0))
    assert max(map(len, dkv)) <= 66


def _segments(rng, b, s, n, monotone, pad):
    ids = rng.integers(1, n + 1, (b, s))
    if monotone:
        ids = np.sort(ids, -1)
    ids[:, s - pad:] = 0
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_masked_plans_cover_segments(causal, monotone):
    """Segment ids, sorted (packed documents) or arbitrary (the stats are
    conservative), with padded tails of id 0; s 333."""
    rng = np.random.default_rng(int(causal) + 2 * int(monotone))
    b, h, hk, s = 2, 4, 2, 333
    check_flag_plans(
        b, h, hk, s, s, causal,
        q_segment_ids=_segments(rng, b, s, 5, monotone, 40),
        kv_segment_ids=_segments(rng, b, s, 5, monotone, 17))


def _varlen_flags(cu_q, cu_k, tq, tk):
    """The segment ids and bottom-right aligned positions of a varlen call
    (interface.flash_attn_varlen_func's own)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import interface
    cu_q, cu_k = (torch.tensor(c, dtype=torch.int32) for c in (cu_q, cu_k))
    lq, seq = interface._local_positions(cu_q, tq)
    lk, _ = interface._local_positions(cu_k, tk)
    off = ((cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1]))[seq]
    return dict(
        q_segment_ids=interface._segment_ids_from_cu_seqlens(cu_q, tq)[None],
        kv_segment_ids=interface._segment_ids_from_cu_seqlens(cu_k, tk)[None],
        q_positions=(lq + off)[None], kv_positions=lk[None])


@pytest.mark.parametrize("window", [(-1, -1), (47, -1)])
def test_masked_plans_cover_varlen_positions(window):
    """Varlen with cu_seqlens_q != cu_seqlens_k (the card test's packing):
    segment ids and per-sequence positions, causal on the positions, with
    and without a left window; the tile ranges cut the candidates."""
    flags = _varlen_flags([0, 100, 130, 400, 410], [0, 60, 250, 500, 530],
                          420, 530)
    plan, dkv = check_flag_plans(1, 4, 2, 420, 530, True, window, **flags)
    dense = sum(len(c) for c in fwd.fwd_tile_plan(420, 530, False)) * 4
    assert sum(map(len, plan.values())) < dense


@pytest.mark.parametrize("combo", ["window+flashmask", "segments+block",
                                   "positions+flashmask", "positions+block"])
def test_masked_plans_cover_flag_combinations(combo):
    """Windows, segments and positions ANDed with a FlashMask (causal_2,
    one mask head per query head) or a block mask at granularity 64."""
    rng = np.random.default_rng(len(combo))
    b, h, hk, s = 2, 4, 2, 320
    flags, window = {}, (-1, -1)
    if "window" in combo:
        window = (90, 0)
    if "segments" in combo:
        flags.update(q_segment_ids=_segments(rng, b, s, 3, True, 0),
                     kv_segment_ids=_segments(rng, b, s, 3, True, 0))
    if "positions" in combo:
        pos = torch.from_numpy((np.arange(s)[None] * 2
                                + np.array([[0], [7]])).astype(np.int32))
        flags.update(q_positions=pos, kv_positions=pos)
        window = (150, 0)
    if "flashmask" in combo:
        flags.update(_fm_flags(len(combo), True, 2, b, h, s))
    if "block" in combo:
        flags["block_mask"] = (torch.from_numpy(
            (rng.random((b, 1, 5, 5)) < 0.7).astype(np.int32)), 64, 64)
    check_flag_plans(b, h, hk, s, s, True, window, **flags)


@pytest.mark.parametrize("block", [64, 128])
def test_token_stats_match_jax(block):
    """Segment stats (the last id repeated into the padding) and position
    stats (padding POS_PAD) per kernel tile equal the JAX package's
    seg_block_stats and pos_pad_and_stats, exactly."""
    rng = np.random.default_rng(block)
    b, s = 2, 300
    seg = rng.integers(0, 6, (b, s)).astype(np.int32)
    pos = rng.integers(-50, 500, (b, s)).astype(np.int32)
    _, src = common.token_pairs(torch.from_numpy(seg), torch.from_numpy(pos),
                                b, s, "cpu")
    st = common.token_stats(src, s, block).numpy()
    jseg = np.asarray(jcommon.seg_block_stats(jnp.asarray(seg), block))
    _, jpos = jcommon.pos_pad_and_stats(jnp.asarray(pos), block)
    np.testing.assert_array_equal(st[..., :2].reshape(-1), jseg)
    np.testing.assert_array_equal(st[..., 2:].reshape(-1), np.asarray(jpos))
    assert common.POS_PAD == jcommon.POS_PAD


def test_resolve_window():
    """causal sets the right bound to 0; positions move both bounds onto
    the positions; bounds that cut no pair are dropped."""
    rw = common.resolve_window
    assert rw(True, (-1, -1), 100, 100, False) == (True, (-1, -1), (-1, -1))
    assert rw(True, (10, 5), 100, 100, False) == (False, (10, 0), (-1, -1))
    assert rw(False, (-1, 0), 100, 100, False) == (True, (-1, -1), (-1, -1))
    assert rw(True, (99, 0), 100, 100, False) == (True, (-1, -1), (-1, -1))
    assert rw(False, (5, 99), 100, 100, False) == (False, (5, -1), (-1, -1))
    assert rw(True, (7, -1), 100, 100, True) == (False, (-1, -1), (7, 0))


# ---- the fp32 kernels' tiles (csrc/flash_fp32.cu's masked instantiations)

def test_kernel_tiles_of_the_fp32_kernels():
    """The fp32 kinds of kernel_tiles are csrc/flash_fp32.cu's tiles (the
    forward's 64 / 32 keys, dK/dV's 32 / 16 rows against 128 / 64 keys,
    dQ's 32 / 16 keys, at d 64 / 128; 128-row blocks), every one dividing
    the FlashMask and token paddings; the bf16 kinds are unchanged."""
    want = {("fwd_fp32", 64): (128, 64), ("fwd_fp32", 128): (128, 32),
            ("dkv_fp32", 64): (32, 128), ("dkv_fp32", 128): (16, 64),
            ("dq_fp32", 64): (128, 32), ("dq_fp32", 128): (128, 16),
            ("fwd", 64): (128, 128), ("dkv", 128): (64, 128),
            ("dq", 64): (128, 128), ("dq", 128): (128, 64)}
    for (kind, d), tiles in want.items():
        assert common.kernel_tiles(kind, d) == tiles
        for t in tiles:
            assert common.FM_PAD_KEYS % t == 0 and common.TOKEN_PAD % t == 0


def check_fp32_plans(b, h, hk, sq, sk, causal, window=(-1, -1), **flags):
    """The fp32 kernels' mirrors (forward, dK/dV, dQ at d 64 and 128, with
    ``fp32``) under the flags as the entry resolves them, held to the dense
    keep mask of every flag; the stats, token stats and tile ranges at the
    fp32 tiles made once per tile size (KernelMasks), the ranges of the
    "dkv_fp32" kind per key block. Returns the visible pairs counted."""
    eff, masks = fwd.build_masks(b, h, sq, sk, causal, window, **flags)
    keep = masks.keep(h)
    keep = (torch.ones(1, 1, sq, sk, dtype=torch.bool) if keep is None
            else common.expand_heads(keep, h))
    vis = keep.expand(b, h, sq, sk)
    if eff:
        rows, cols = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        vis = vis & (cols <= rows + (sk - sq))
    counted = []
    for d in (64, 128):
        m, n = common.kernel_tiles("dkv_fp32", d)
        counted.append(_check_dkv(
            bwd.bwd_masked_dkv_tile_plan(masks, b, h, hk, sq, sk, eff, d,
                                         fp32=True), vis, h, hk, sq, sk, m, n))
        counted.append(_check_row_block_plan(
            bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, sq, sk, eff, d,
                                        fp32=True),
            vis, sq, sk, common.kernel_tiles("dq_fp32", d)[1]))
        counted.append(_check_row_block_plan(
            fwd.fwd_masked_tile_plan(masks, b, h, sq, sk, eff, d, fp32=True),
            vis, sq, sk, common.kernel_tiles("fwd_fp32", d)[1]))
        if masks.has_tokens:
            rng = masks.ranges("dkv_fp32", d)
            assert rng.shape[1] == -(-sk // n)  # per key block
            assert masks.ranges("dkv_fp32", d) is rng  # made once
    assert all(counted)
    return counted


FP32_PLAN_CASES = ["flashmask causal_1", "flashmask full_4 hm4", "block 64",
                   "segments", "varlen window", "window+block"]


@pytest.mark.parametrize("case", FP32_PLAN_CASES)
def test_fp32_masked_plans_cover_the_flags(case):
    """The fp32 masked kernels' mirrors cover every visible pair at their
    own tiles (16- to 64-key tiles, 16- and 32-row query tiles) under a
    FlashMask (a causal document mask; full_4 with a mask head per query
    head), a block mask at granularity 64, segment ids with padded tails,
    varlen positions with a left window, and a window with a block mask;
    s 200 to 420 (ragged), GQA."""
    rng = np.random.default_rng(FP32_PLAN_CASES.index(case) + 90)
    b, h, hk, s = 2, 4, 2, 200
    if case == "flashmask causal_1":
        ids = torch.from_numpy(np.sort(rng.integers(0, 5, (b, s)), -1))
        check_fp32_plans(b, h, hk, s, s, True, flashmask_vecs=(
            causal_document_mask(ids).movedim(-1, 2)),
            flashmask_mode="causal_1")
    elif case == "flashmask full_4 hm4":
        check_fp32_plans(b, h, hk, s, s, False,
                         **_fm_flags(7, False, 4, b, h, s))
    elif case == "block 64":
        bm = (rng.random((b, 1, 4, 4)) < 0.6).astype(np.int32)
        check_fp32_plans(b, h, hk, s, s, False,
                         block_mask=(torch.from_numpy(bm), 64, 64))
    elif case == "segments":
        check_fp32_plans(b, h, hk, 333, 333, True,
                         q_segment_ids=_segments(rng, b, 333, 5, True, 40),
                         kv_segment_ids=_segments(rng, b, 333, 5, True, 17))
    elif case == "varlen window":
        flags = _varlen_flags([0, 100, 130, 400, 410],
                              [0, 60, 250, 500, 530], 420, 530)
        check_fp32_plans(1, h, hk, 420, 530, True, (47, -1), **flags)
    else:
        bm = (rng.random((b, 1, 4, 4)) < 0.7).astype(np.int32)
        check_fp32_plans(b, h, hk, s, s, True, (90, 0),
                         block_mask=(torch.from_numpy(bm), 64, 64))
