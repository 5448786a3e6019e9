"""Port parity: the backward passes against the JAX package's VJPs.

The same numpy inputs and output cotangents go through ``jax.vjp`` of the
JAX package's functions (Pallas kernels in interpret mode on the CPU) and
``torch.autograd.grad`` of the port's (plain versions on CPU tensors), in
fp32:
  * flash_attention (causal and full, GQA, softcap): dq, dk, dv within 5e-5
    of JAX's, relative to each gradient's largest entry;
  * packed_qkv_attention (one packed dqkv) and packed_heads_attention
    (dq, dk, dv): likewise;
  * dropout_add_layer_norm / dropout_add_rms_norm (prenorm,
    residual_in_fp32, with and without a residual): dx0, dresidual, dgamma,
    dbeta within 1e-5 relative;
  * cross_entropy_loss (label smoothing, ignore_index, lse_square_scale):
    losses and dlogits within 1e-5 relative.
Two fp32 computations of the same formulas differ only in the order of
their sums, hence the relative tolerances.

Also, in pure Python, the mirrors of what the dense backward kernels visit
(csrc/flash_bwd.cu): the query tiles of each dK/dV key block and the key
tiles of each dQ query block cover every visible (row, key) pair once and
mark as masked exactly the tiles that hold an invisible pair; the
persistent schedules run every block once, in equal-work pairs; and the
pre-pass's plain version gives the plain backward's q_s and delta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.losses.cross_entropy import (
    cross_entropy_loss as jce,
)
from xhy_flash_attention_tpu.ops import layer_norm as jln
from xhy_flash_attention_tpu.ops.flash_attention import fused_heads as jfh
from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
)
from xhy_flash_attention_tpu_torch.losses import cross_entropy_loss
from xhy_flash_attention_tpu_torch.ops import layer_norm as tln
from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd as tbwd
from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as tfh
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attn_func,
    flash_attn_qkvpacked_func,
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


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _torch_grads(fn, arrays, cotangents):
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(
        outs, ins, [torch.from_numpy(c) for c in cotangents],
        allow_unused=True)
    return outs, grads


def _jax_grads(fn, arrays, cotangents):
    outs, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    if not isinstance(outs, tuple):
        return (outs,), vjp(jnp.asarray(cotangents[0]))
    return outs, vjp(tuple(map(jnp.asarray, cotangents)))


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (96, 160)])
def test_flash_attention_grads_match_jax(sq, sk, causal, softcap):
    rng = np.random.default_rng(sq + sk + int(causal))
    arrays = [_randn(rng, (B, H, sq, D)), _randn(rng, (B, HK, sk, D)),
              _randn(rng, (B, HK, sk, D))]
    do = _randn(rng, (B, H, sq, D))
    kw = dict(causal=causal, softcap=softcap)
    (want,), wgrads = _jax_grads(lambda q, k, v: jflash_attention(q, k, v, **kw),
                                 arrays, [do])
    (got,), tgrads = _torch_grads(lambda q, k, v: flash_attention(q, k, v, **kw),
                                  arrays, [do])
    _close(got, want, 1e-5)
    for g, w in zip(tgrads, wgrads):
        _close(g, w, 5e-5)


def test_flash_attn_func_and_qkvpacked_grads():
    """The (b, s, h, d) entries are views over flash_attention: their
    gradients equal it bit for bit."""
    rng = np.random.default_rng(5)
    qkv = _randn(rng, (B, 64, 3, H, D))
    do = _randn(rng, (B, 64, H, D))
    _, (packed,) = _torch_grads(
        lambda x: flash_attn_qkvpacked_func(x, causal=True), [qkv], [do])
    _, split = _torch_grads(
        lambda q, k, v: flash_attn_func(q, k, v, causal=True),
        [np.ascontiguousarray(qkv[:, :, i]) for i in range(3)], [do])
    for i in range(3):
        assert torch.equal(packed[:, :, i], split[i])


@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2)])
def test_packed_qkv_attention_grads_match_jax(h, hk):
    s = 96
    rng = np.random.default_rng(h + hk)
    qkv = _randn(rng, (B, s, (h + 2 * hk) * D))
    do = _randn(rng, (B, s, h * D))
    kw = dict(num_heads=h, num_heads_kv=hk, head_dim=D, causal=True)
    (want,), (wg,) = _jax_grads(lambda x: jfh.packed_qkv_attention(x, **kw),
                                [qkv], [do])
    (got,), (tg,) = _torch_grads(lambda x: tfh.packed_qkv_attention(x, **kw),
                                 [qkv], [do])
    _close(got, want, 1e-5)
    _close(tg, wg, 5e-5)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_heads_attention_grads_match_jax(causal, softcap):
    s = 128
    rng = np.random.default_rng(11 + int(causal))
    arrays = [_randn(rng, (B, s, H, D)), _randn(rng, (B, s, HK, D)),
              _randn(rng, (B, s, HK, D))]
    do = _randn(rng, (B, s, H, D))
    kw = dict(causal=causal, softcap=softcap)
    (want,), wgrads = _jax_grads(
        lambda q, k, v: jfh.packed_heads_attention(q, k, v, **kw), arrays,
        [do])
    (got,), tgrads = _torch_grads(
        lambda q, k, v: tfh.packed_heads_attention(q, k, v, **kw), arrays,
        [do])
    _close(got, want, 1e-5)
    for g, w in zip(tgrads, wgrads):
        _close(g, w, 5e-5)


@pytest.mark.parametrize("has_residual", [False, True])
@pytest.mark.parametrize("residual_in_fp32", [False, True])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("rms", [True, False])
def test_dropout_add_norm_grads_match_jax(rms, prenorm, residual_in_fp32,
                                          has_residual):
    rng = np.random.default_rng(3)
    hid = 256
    arrays = [_randn(rng, (2, 8, hid))]
    if has_residual:
        arrays.append(_randn(rng, (2, 8, hid), 3.0))
    arrays.append((1 + 0.1 * rng.standard_normal(hid)).astype(np.float32))
    if not rms:
        arrays.append(_randn(rng, (hid,), 0.1))
    cots = [_randn(rng, (2, 8, hid))] + (
        [_randn(rng, (2, 8, hid))] if prenorm else [])
    kw = dict(prenorm=prenorm, residual_in_fp32=residual_in_fp32)

    def call(mod):
        fn = mod.dropout_add_rms_norm if rms else mod.dropout_add_layer_norm

        def f(*a):
            a = list(a)
            x0 = a.pop(0)
            res = a.pop(0) if has_residual else None
            w = a.pop(0)
            b = a.pop(0) if not rms else None
            out = fn(x0, res, w, b, 0.0, 1e-5, **kw)
            return tuple(out) if prenorm else out
        return f

    wouts, wgrads = _jax_grads(call(jln), arrays, cots)
    touts, tgrads = _torch_grads(call(tln), arrays, cots)
    for g, w in zip(touts, wouts):
        _close(g, w, 1e-5)
    for g, w in zip(tgrads, wgrads):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("lse_square_scale", [0.0, 1e-3])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing, lse_square_scale):
    rng = np.random.default_rng(7)
    n, v = 48, 300
    logits = _randn(rng, (n, v), 3.0)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[[3, 17]] = -100  # ignore_index rows: zero loss and gradient
    g = _randn(rng, (n,))
    kw = dict(label_smoothing=smoothing, lse_square_scale=lse_square_scale)
    want, vjp = jax.vjp(lambda x: jce(x, jnp.asarray(labels), **kw),
                        jnp.asarray(logits))
    (wg,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(x, torch.from_numpy(labels).long(), **kw)
    (tg,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    _close(got, want, 1e-5)
    _close(tg, wg, 1e-5)
    assert not tg[[3, 17]].any() and not got[[3, 17]].any()


# ---- the dense backward kernels' plans and schedules (pure Python)

PLAN_SHAPES = [(128, 128), (2048, 2048), (1100, 1100), (77, 300), (300, 77),
               (1, 1), (129, 2049), (2049, 129), (960, 960), (64, 200)]


def _visible(sq, sk, causal):
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    return (cols <= rows + (sk - sq)) if causal else \
        torch.ones(sq, sk, dtype=torch.bool)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_bwd_dkv_tile_plan_covers_the_visible_pairs(sq, sk, causal, g):
    """Each key block visits, for every head of its group in turn, query
    tiles that cover each visible (head, row, key) pair of its keys exactly
    once; every visited tile holds a visible pair; a tile is masked exactly
    when it holds an invisible pair of the block's keys below sk (rows past
    sq count as invisible); the masked tiles come first."""
    m, n = tbwd.BWD_DKV_TILE_M, tbwd.BWD_DKV_TILE_N
    vis = _visible(sq, sk, causal)
    plan = tbwd.bwd_dkv_tile_plan(sq, sk, causal)
    assert len(plan) == -(-sk // n)
    for nb, tiles in enumerate(plan):
        keys = slice(nb * n, min((nb + 1) * n, sk))
        masked = [flag for _, flag in tiles]
        assert masked == sorted(masked, reverse=True)
        covered = torch.zeros(g, sq, keys.stop - keys.start, dtype=torch.int)
        for head in range(g):
            for t, flag in tiles:
                rows = torch.arange(t * m, (t + 1) * m)
                inside = rows < sq
                block = torch.zeros(m, keys.stop - keys.start,
                                    dtype=torch.bool)
                block[inside] = vis[rows[inside], keys]
                assert block.any()
                assert flag == bool((~block).any())
                covered[head, t * m:(t + 1) * m] += 1
        assert torch.equal(covered.clamp(max=1).bool() & vis[:, keys],
                           vis[:, keys].expand(g, -1, -1))
        assert covered.max() <= 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_bwd_dq_tile_plan_covers_the_visible_pairs(sq, sk, causal, d):
    """Each query block visits key tiles that cover each visible pair of
    its rows exactly once, last tile first; every visited tile holds a
    visible pair; a tile is masked exactly when it holds an invisible pair
    of the block's rows below sq (keys past sk count as invisible); the
    masked tiles come first."""
    m, n = tbwd.BWD_DQ_TILE_M, tbwd.bwd_dq_tile_n(d)
    vis = _visible(sq, sk, causal)
    plan = tbwd.bwd_dq_tile_plan(sq, sk, causal, d)
    assert len(plan) == -(-sq // m)
    for mb, tiles in enumerate(plan):
        rows = vis[mb * m:(mb + 1) * m]
        order = [t for t, _ in tiles]
        assert order == sorted(set(order), reverse=True)
        masked = [flag for _, flag in tiles]
        assert masked == sorted(masked, reverse=True)
        covered = torch.zeros(sk, dtype=torch.int)
        for t, flag in tiles:
            cols = torch.arange(t * n, (t + 1) * n)
            inside = cols < sk
            block = torch.zeros(rows.shape[0], n, dtype=torch.bool)
            block[:, inside] = rows[:, cols[inside]]
            assert block.any()
            assert flag == bool((~block).any())
            covered[t * n:(t + 1) * n] += 1
        assert not (rows & (covered == 0)).any()


@pytest.mark.parametrize("which,d", [("dkv", 64), ("dq", 64), ("dq", 128)])
@pytest.mark.parametrize("s,h,hk,b", [(2048, 16, 16, 16), (2048, 32, 8, 2),
                                      (1024, 16, 16, 32), (1100, 8, 2, 2),
                                      (300, 4, 1, 3), (1, 2, 2, 1)])
def test_bwd_schedule_runs_every_block_once(which, s, h, hk, b, d):
    """The persistent CTAs (132, an H100's SMs, or fewer when there are
    fewer pairs) run every (batch, head, block) exactly once; the blocks of
    a pair hold equal causal work when the length is a multiple of the
    blocks (the middle one of an odd count alone), and the CTAs' loads
    differ by at most one pair's."""
    if which == "dkv":
        heads, size = hk, tbwd.BWD_DKV_TILE_N
        tiles = [len(t) * (h // hk)
                 for t in tbwd.bwd_dkv_tile_plan(s, s, True)]
    else:
        heads, size = h, tbwd.BWD_DQ_TILE_M
        tiles = [len(t) for t in tbwd.bwd_dq_tile_plan(s, s, True, d)]
    n_blocks = -(-s // size)
    ctas = min(132, (n_blocks + 1) // 2 * heads * b)
    sched = tbwd.bwd_schedule(which, s, s, h, hk, b, ctas)
    assert len(sched) == ctas and all(sched)
    runs = [blk for cta in sched for blk in cta]
    assert sorted(runs) == [(bb, hh, j) for bb in range(b)
                            for hh in range(heads) for j in range(n_blocks)]
    pairs = [tiles[j] + tiles[n_blocks - 1 - j] for j in range(n_blocks // 2)]
    if s % size == 0:
        assert len(set(pairs)) <= 1
    for cta in sched:  # a pair's partners run heavier first
        for (b0, h0, j0), (b1, h1, j1) in zip(cta, cta[1:]):
            if (b0, h0) == (b1, h1) and j0 + j1 == n_blocks - 1:
                assert tiles[j0] >= tiles[j1]
    load = [sum(tiles[j] for _, _, j in cta) for cta in sched]
    assert max(load) - min(load) <= max(tiles) + min(tiles)


@pytest.mark.parametrize("scale_q", [False, True])
def test_bwd_prep_ref_gives_the_plain_backward_inputs(scale_q):
    """The pre-pass's plain version: q_s bit for bit the plain backward's
    q * sm_scale rounded to bf16, delta its fp32 rowsum(dO * O)."""
    rng = np.random.default_rng(3)
    q, out, do = (torch.from_numpy(_randn(rng, (2, 3, 37, 64))).bfloat16()
                  .transpose(1, 2).contiguous().transpose(1, 2)
                  for _ in range(3))
    qs, delta = tbwd.bwd_prep_ref(q, out, do, sm_scale=0.125 ** 0.5,
                                  scale_q=scale_q)
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    assert torch.equal(delta, (do.float() * out.float()).sum(-1))
    if scale_q:
        assert qs.is_contiguous() and qs.dtype == torch.bfloat16
        assert torch.equal(qs, (q.float() * 0.125 ** 0.5).to(torch.bfloat16))
    else:
        assert qs is None
