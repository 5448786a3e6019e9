"""Port parity: FlashMask attention against the JAX package.

The same numpy inputs (fp32) and output cotangents go through ``jax.vjp`` of
the JAX package's ``flashmask_attention`` (Pallas kernels in interpret mode
on the CPU) and ``torch.autograd.grad`` of the port's (the plain versions
with the dense mask on CPU tensors), for the four modes, one mask for all
heads (hm 1) and one per head (hm = h), with GQA (h 4 over hk 2), at a
sequence length that is a multiple of 64 and one that is not, random bands
that leave some rows fully masked. Tolerances: out and dq/dk/dv within 5e-5
of the largest entry (two fp32 computations that sum in another order);
the finite LSE within 1e-5 absolute, the same rows +inf. The mask
constructors agree with the JAX package's bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import flashmask as jfm
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    causal_document_mask,
    flash_attention,
    flashmask_attention,
    flashmask_to_dense,
    global_sliding_window_mask,
    sliding_window_mask,
)

B, H, HK, D = 2, 4, 2, 64
CASES = [(causal, nv, hm) for causal, nv in ((True, 1), (True, 2), (False, 2),
                                            (False, 4)) for hm in (1, H)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_indices(rng, causal, nv, b, hm, sk):
    """Random valid bands, as tests/test_flashmask.py draws them."""
    lts = rng.integers(0, sk + 1, (b, hm, sk, 1))
    if causal:
        if nv == 1:
            return lts.astype(np.int32)
        lte = np.minimum(lts + rng.integers(0, sk, (b, hm, sk, 1)), sk)
        return np.concatenate([lts, lte], -1).astype(np.int32)
    if nv == 2:  # [LTStart, UTEnd], UTEnd <= LTStart
        ute = rng.integers(0, lts + 1)
        return np.concatenate([lts, ute], -1).astype(np.int32)
    lte = np.minimum(lts + rng.integers(0, sk // 2, (b, hm, sk, 1)), sk)
    uts = rng.integers(0, sk + 1, (b, hm, sk, 1))
    ute = np.minimum(uts + rng.integers(0, sk // 2, (b, hm, sk, 1)), sk)
    return np.concatenate([lts, lte, uts, ute], -1).astype(np.int32)


def _inputs(case):
    causal, nv, hm = case
    s = 200 if hm == 1 else 256  # 200: a key tail past the last 64-key tile
    rng = np.random.default_rng(s + 10 * nv + int(causal) + hm)
    q = rng.standard_normal((B, H, s, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, HK, s, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, s, D)).astype(np.float32)
    return (q, k, v), do, random_indices(rng, causal, nv, B, hm, s)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """out, lse, (dq, dk, dv) of the JAX package, once per case."""
    causal = case[0]
    arrays, do, idx = _inputs(case)
    fn = lambda q, k, v: jfm.flashmask_attention(  # noqa: E731
        q, k, v, jnp.asarray(idx), causal=causal, return_lse=True)
    (out, lse), vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _torch_run(case):
    causal = case[0]
    arrays, do, idx = _inputs(case)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out, lse = flashmask_attention(*ins, torch.from_numpy(idx), causal=causal,
                                   return_lse=True)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    return out.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _case_id(case):
    causal, nv, hm = case
    return f"{'causal' if causal else 'full'}_{nv}-hm{hm}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flashmask_forward_matches_jax(case):
    out, lse, _ = _torch_run(case)
    want_out, want_lse, _ = _jax_run(case)
    _close(out, want_out, 5e-5)
    finite = np.isfinite(want_lse)
    np.testing.assert_array_equal(np.isfinite(lse), finite)
    assert (lse[~finite] == np.inf).all()
    np.testing.assert_allclose(lse[finite], want_lse[finite], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flashmask_grads_match_jax(case):
    _, _, grads = _torch_run(case)
    _, _, want = _jax_run(case)
    for g, w in zip(grads, want):
        _close(g, w, 5e-5)


def test_flashmask_fully_masked_rows():
    """LTStart = 0 masks every row (causal_1): out 0, LSE +inf and zero
    gradients; and a mask whose first 64 keys are masked for the first 100
    rows (causal_2) gives those rows the softmax over their later keys."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 160, D))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    idx = torch.zeros(1, 1, 160, 1, dtype=torch.int32)
    out, lse = flashmask_attention(q, k, v, idx, causal=True, return_lse=True)
    assert not out.abs().any() and torch.isinf(lse).all()
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert all(not g.abs().any() for g in grads)

    lts = torch.zeros(1, 1, 160, dtype=torch.int32)
    lte = torch.where(torch.arange(160) < 64, 100, 0).to(torch.int32)[None, None]
    idx = torch.stack([lts, lte], -1)
    out = flashmask_attention(q, k, v, idx, causal=True)
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    rows, cols = torch.arange(160)[:, None], torch.arange(160)[None, :]
    keep = (cols <= rows) & ~((cols < 64) & (rows < 100))
    p = torch.softmax(s.masked_fill(~keep, -torch.inf), -1)
    want = torch.nan_to_num(p) @ v
    _close(out.detach().numpy(), want.detach().numpy(), 1e-5)
    assert not out[:, :, :64].abs().any()  # rows < 64 see no key


def test_flashmask_trivial_equals_causal():
    """LTStart = seqlen masks nothing beyond causal: bit for bit the plain
    causal attention."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, 128, D))
                                .astype(np.float32)) for _ in range(3))
    idx = torch.full((B, 1, 128, 1), 128, dtype=torch.int32)
    assert torch.equal(flashmask_attention(q, k, v, idx, causal=True),
                       flash_attention(q, k, v, causal=True))


def test_mask_constructors_match_jax():
    b, s, w, g = 2, 128, 16, 8
    doc = np.repeat(np.arange(4), s // 4)[None].repeat(b, 0).astype(np.int32)
    doc[1] = np.repeat([0, 1, 2, 3], [5, 50, 60, 13])
    pairs = [
        (causal_document_mask(torch.from_numpy(doc)),
         jfm.causal_document_mask(jnp.asarray(doc))),
        (sliding_window_mask(b, s, w, device="cpu"),
         jfm.sliding_window_mask(b, s, w)),
        (global_sliding_window_mask(b, s, w, g, device="cpu"),
         jfm.global_sliding_window_mask(b, s, w, g)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(4)
    for causal, nv in ((True, 1), (True, 2), (False, 2), (False, 4)):
        idx = random_indices(rng, causal, nv, b, 2, s)
        np.testing.assert_array_equal(
            flashmask_to_dense(torch.from_numpy(idx), 96, causal).numpy(),
            np.asarray(jfm.flashmask_to_dense(jnp.asarray(idx), 96, causal)))


def test_flashmask_rejects_bad_encodings():
    q = torch.zeros(1, 2, 64, D)
    with pytest.raises(ValueError):
        flashmask_attention(q, q, q, torch.zeros(1, 1, 64, 1), causal=False)
    with pytest.raises(ValueError):
        flashmask_attention(q, q, q, torch.zeros(1, 1, 32, 1), causal=True)
    with pytest.raises(ValueError):
        flashmask_attention(q, q, q, torch.zeros(1, 3, 64, 1), causal=True)


@pytest.mark.parametrize("causal,nv", [(True, 1), (True, 2), (False, 2),
                                       (False, 4)])
def test_tile_stats_are_conservative(causal, nv):
    """The tile decisions the kernels take from the per-tile stats (here
    through the plain fm_skip_bypass, at the forward's 64-key tiles of 64
    rows, the backward's 128-key dK/dV blocks against 64-row query tiles
    and its 128- or 64-key dQ tiles against 128-row blocks, and 32-key
    tiles): a skipped tile is masked everywhere and a bypassed one nowhere,
    the padded tail tile included (sk 200 is no multiple of 64)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import common
    sq = sk = 200
    rng = np.random.default_rng(11 + nv)
    vecs = torch.from_numpy(random_indices(rng, causal, nv, 2, 2, sk)
                            ).movedim(-1, 2)
    mode = common.fm_mode_for(causal, nv)
    keep = common.fm_keep_mask(vecs, mode, sq)
    masks = common.KernelMasks(2, 4, sq, sk, flashmask_vecs=vecs,
                               flashmask_mode=mode)
    skipped = bypassed = 0
    for tk, tq in ((64, 64), (32, 64), (64, 32), (128, 64), (128, 128),
                   (64, 128)):
        st = masks.stats(tk)  # (b, hm, tiles, nv, 2)
        assert st.shape[2] == masks.fm_vecs.shape[-1] // tk
        for q0 in range(0, sq, tq):
            q1 = min(q0 + tq, sq)
            skip, bypass = common.fm_skip_bypass(
                mode, lambda v, w: st[..., v, w], q0, q1)  # (b, hm, tiles)
            for t in range(st.shape[2]):
                tile = keep[:, :, q0:q1, t * tk:min((t + 1) * tk, sk)]
                assert not (skip[..., t] & tile.flatten(2).any(-1)).any()
                full = tile.flatten(2).all(-1) & ((t + 1) * tk <= sk)
                assert not (bypass[..., t] & ~full).any()
                skipped += int(skip[..., t].sum())
                bypassed += int(bypass[..., t].sum())
    assert skipped + bypassed > 0
