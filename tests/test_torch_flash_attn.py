"""Port parity: prefill attention against the JAX package.

The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode on the CPU) and the port (plain versions on CPU tensors):
  * flash_attention / flash_attn_func, causal and full, GQA, softcap, LSE:
    fp32 within 2e-5 of JAX and of the fp32 `attention_ref`; bf16 by the
    repo's contract (error against the fp32 reference at most twice the
    error of the bf16 reorder-ops baseline);
  * packed_heads_attention and packed_qkv_attention (the projection-layout
    kernel's entries) within 2e-5 of JAX in fp32;
  * the dense CUDA kernel's tile plan (`fwd_tile_plan`, the mirror of its
    `dense_tiles`) against the pairs the plain version lets through;
  * flash_attn_func with dropout (p 0.1, a seed) against JAX in fp32 and
    by the contract in bf16, and the refusals that stay on the card.
"""

import functools


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import fused_heads as jfh
from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
    flash_attn_func as jflash_attn_func,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    attention_ref,
    flash_attention,
    flash_attn_func,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as tfh
from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd as tfwd
from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
    NO_BACKWARD,
    Dropout,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention.decode_kernel import (
    flash_decode,
)

B, H, HK, D = 2, 4, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (113, 203)])
def test_flash_attention_fp32_matches_jax(sq, sk, causal, softcap):
    rng = np.random.default_rng(sq + sk)
    q, k, v = _randn(rng, (B, H, sq, D)), _randn(rng, (B, HK, sk, D)), \
        _randn(rng, (B, HK, sk, D))
    want, want_lse = jflash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap, return_lse=True)
    got, got_lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softcap=softcap, return_lse=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)
    # rows that see no key carry lse = +inf in both packages
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), rtol=0, atol=2e-5)
    ref, _ = attention_ref(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=causal, softcap=softcap)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(ref), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (113, 203)])
def test_flash_attn_func_bf16_contract(sq, sk, causal):
    rng = np.random.default_rng(7 * sq + sk)
    q, k, v = (_bf16_round(_randn(rng, s)) for s in
               ((B, sq, H, D), (B, sk, HK, D), (B, sk, HK, D)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attn_func(tq, tk, tv, causal=causal)
    want = jflash_attention(
        *(jnp.asarray(a, jnp.bfloat16).swapaxes(1, 2) for a in (q, k, v)),
        causal=causal).swapaxes(1, 2)
    ref, _ = attention_ref(tq, tk, tv, causal=causal, upcast=True)
    lp, _ = attention_ref(tq, tk, tv, causal=causal, upcast=False,
                          reorder_ops=True)
    err_lp = np.abs(_np(lp) - _np(ref)).max()
    assert np.abs(_np(got) - _np(ref)).max() <= 2 * err_lp + 1e-4
    assert np.abs(_np(want) - _np(ref)).max() <= 2 * err_lp + 1e-4


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_heads_attention_matches_jax(causal, softcap):
    s = 128
    rng = np.random.default_rng(11)
    q, k, v = _randn(rng, (B, s, H, D)), _randn(rng, (B, s, HK, D)), \
        _randn(rng, (B, s, HK, D))
    assert tfh.packed_heads_supported(
        q.shape, k.shape, causal=causal, window_size=(-1, -1), softcap=softcap)
    want = jfh.packed_heads_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap)
    got = tfh.packed_heads_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softcap=softcap)
    assert got.shape == (B, s, H, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2)])
def test_packed_qkv_attention_matches_jax(h, hk):
    s = 96
    rng = np.random.default_rng(h + hk)
    qkv = _randn(rng, (B, s, (h + 2 * hk) * D))
    want = jfh.packed_qkv_attention(
        jnp.asarray(qkv), num_heads=h, num_heads_kv=hk, head_dim=D,
        causal=True)
    got = tfh.packed_qkv_attention(
        torch.from_numpy(qkv), num_heads=h, num_heads_kv=hk, head_dim=D,
        causal=True)
    assert got.shape == (B, s, h * D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,ok", [
    (((2, 1024, 4, 64), (2, 1024, 2, 64)), True),
    (((2, 1025, 4, 64), (2, 1025, 2, 64)), False),
    (((2, 64, 4, 64), (2, 64, 1, 64)), False),   # hk * d not a multiple of 128
    (((2, 64, 4, 64), (2, 80, 2, 64)), False),   # sq != sk
])
def test_packed_gate_matches_jax(shape, ok):
    qs, ks = shape
    kw = dict(causal=True, window_size=(-1, -1), softcap=0.0)
    assert tfh.packed_heads_supported(qs, ks, **kw) is ok
    assert jfh.packed_heads_supported(qs, ks, **kw) is ok


def test_attention_inputs_needing_grad_raise():
    """Prefill attention is differentiable now (slice 3); decode against a
    cache has no backward, as in the TPU package, and raises."""
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    k = torch.randn(1, 2, 8, 64)
    assert flash_attention(q, k, k, causal=True).grad_fn is not None
    assert tfh.packed_heads_attention(
        q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2)
    ).grad_fn is not None
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode(q.transpose(1, 2)[:, :1], k, k, lengths,
                     softmax_scale=0.125)
    with torch.no_grad():
        flash_decode(q.transpose(1, 2)[:, :1], k, k, lengths,
                     softmax_scale=0.125)
    assert "no backward" in NO_BACKWARD


@functools.lru_cache(maxsize=None)
def _jax_dropout():
    """fp32 inputs (b, s, h, d) and the JAX package's flash_attn_func with
    dropout 0.1, seed 0, causal: one JAX call for the module."""
    rng = np.random.default_rng(21)
    q = _randn(rng, (B, 128, H, D))
    k, v = _randn(rng, (B, 128, HK, D)), _randn(rng, (B, 128, HK, D))
    out = jflash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           dropout_p=0.1, causal=True, dropout_seed=0)
    return q, k, v, np.asarray(out)


@pytest.mark.parametrize("kw", [dict(dtype=torch.bfloat16, dropout_p=0.1,
                                     dropout_seed=0),
                                dict(dropout_p=0.1, dropout_seed=0)])
def test_unported_flags_raise(kw):
    """Dropout, once refused, runs on the CPU as in the JAX package: fp32
    within 2e-5 of JAX's flash_attn_func, bf16 by the contract against the
    fp32 reference under the same keep mask. What stays refused on the card
    raises before any work (a meta tensor stands in for the card's): dropout
    in float32, and in bf16 beside an attention bias."""
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float32)
    q, k, v, want = _jax_dropout()
    ins = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    got = flash_attn_func(*ins, causal=True, **kw)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-5)
    else:
        keep = Dropout.make(0.1, 0).keep(B, H, 128, 128)
        ref, _ = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, dropout_p=0.1, dropout_mask=keep)
        lp, _ = attention_ref(*ins, causal=True, dropout_p=0.1,
                              dropout_mask=keep, upcast=False,
                              reorder_ops=True)
        np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=2e-5)
        err = (got.float() - ref).abs().max().item()
        assert err <= 2 * (lp.float() - ref).abs().max().item() + 1e-4
    meta = torch.empty(1, 2, 8, 64, dtype=dtype, device="meta")
    bias = None if dtype == torch.float32 else torch.zeros(8, 8,
                                                           device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(meta, meta, meta, bias, causal=True, **kw)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (129, 2049), (2048, 2048),
                                   (1100, 1100), (77, 300), (300, 77),
                                   (1, 1), (256, 1000), (1000, 256),
                                   (960, 960)])
def test_fwd_tile_plan_covers_the_visible_pairs(sq, sk, causal):
    """Every pair the plain version keeps (the bottom-right causal rule of
    `attention_fwd_ref`, keys below sk) lies in a tile the kernel visits;
    every visited tile holds a visible pair of the block's rows; a tile
    marked mask-free is visible over all its in-range rows and columns; the
    masked tiles come first (one loop runs them, another the rest)."""
    m, n = tfwd.FWD_DENSE_TILE_M, tfwd.FWD_DENSE_TILE_N
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    visible = (cols <= rows + (sk - sq)) if causal else \
        torch.ones(sq, sk, dtype=torch.bool)
    plan = tfwd.fwd_tile_plan(sq, sk, causal)
    assert len(plan) == -(-sq // m)
    for mb, tiles in enumerate(plan):
        vis = visible[mb * m:(mb + 1) * m]
        order = [t for t, _ in tiles]
        assert order == sorted(set(order), reverse=True)
        masked = [flag for _, flag in tiles]
        assert masked == sorted(masked, reverse=True)
        covered = torch.zeros(sk, dtype=torch.bool)
        for t, flag in tiles:
            block = vis[:, t * n:(t + 1) * n]
            assert block.any()
            covered[t * n:(t + 1) * n] = True
            if not flag:
                assert block.shape[1] == n and block.all()
        assert not (vis & ~covered).any()


@pytest.mark.parametrize("sq,h,b", [(2048, 32, 2), (960, 32, 2),
                                    (2048, 16, 16), (300, 4, 3), (1, 2, 1),
                                    (1100, 8, 2)])
def test_fwd_schedule_runs_every_block_once(sq, h, b):
    """The persistent CTAs (132, an H100's SMs, or fewer when there are
    fewer pairs) run every (batch, head, query block) exactly once, and
    under the causal plan their key tiles differ by at most one pair's."""
    n_mb = -(-sq // tfwd.FWD_DENSE_TILE_M)
    ctas = min(132, (n_mb + 1) // 2 * h * b)
    sched = tfwd.fwd_schedule(sq, h, b, ctas)
    assert len(sched) == ctas and all(sched)
    runs = [blk for cta in sched for blk in cta]
    assert sorted(runs) == [(bb, hh, m) for bb in range(b) for hh in range(h)
                            for m in range(n_mb)]
    tiles = [len(t) for t in tfwd.fwd_tile_plan(sq, sq, True)]
    load = [sum(tiles[m] for _, _, m in cta) for cta in sched]
    assert max(load) - min(load) <= max(tiles) + min(tiles)
