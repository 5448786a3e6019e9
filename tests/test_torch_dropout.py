"""Port parity: attention dropout against the JAX package.

The keep mask is integer-exact: ``common.dropout_keep_mask`` against the JAX
package's (common.py:120-144) bit for bit, over odd shapes, seeds of both
signs and p in {0, 0.1, 0.5, 0.99}. Then the same numpy inputs and output
cotangents through ``jax.vjp`` of the JAX package's entries (Pallas kernels
in interpret mode on the CPU) and ``torch.autograd.grad`` of the port's
(the plain versions on CPU tensors), with dropout p 0.1 and one seed, so
that both draw the same mask: ``flash_attn_func`` causal (sq < sk, GQA 2),
full (sq > sk), with a window, ``flash_attention`` with segment ids,
``flash_attn_varlen_func`` over three documents, and the packed qkv entry
(the #5 / #6 route), in fp32 within 5e-5 of the largest entry (sums in
another order); bf16 by the repository's contract (error against the fp32
result at most twice the bf16 baseline's under the same keep mask). The
S_dmask of ``return_attn_probs`` (dropped entries negated), MHA with an
explicit ``dropout_seed`` on both routes against the JAX MHA and with a
seed drawn from a generator, and the refusals that stay on the card (a
meta tensor stands in for the card's), raised before any work.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.modules.mha import MHA as JMHA
from xhy_flash_attention_tpu.ops.flash_attention import fused_heads as jfh
from xhy_flash_attention_tpu.ops.flash_attention import interface as jif
from xhy_flash_attention_tpu.ops.flash_attention.common import (
    dropout_keep_mask as jkeep,
)
from xhy_flash_attention_tpu_torch.modules.mha import MHA, draw_dropout_seed
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    attention_ref,
    blocksparse_attention,
    flash_attention,
    flash_attn_func,
    flash_attn_varlen_func,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as tfh
from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
    Dropout,
    dropout_keep_mask,
)

B, H, HK, D = 2, 4, 2, 64
P, SEED = 0.1, 11
DROP = dict(dropout_p=P, dropout_seed=SEED)


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


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ the keep mask

@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.99])
def test_keep_mask_matches_jax_bit_for_bit(p):
    for rows, cols, r0, c0 in ((1, 1, 0, 0), (37, 93, 5, 1000),
                               (128, 257, 4096, 0)):
        r = (r0 + np.arange(rows, dtype=np.int32))[:, None]
        c = (c0 + np.arange(cols, dtype=np.int32))[None, :]
        for seed in (0, 1, -1, 123456789, 2 ** 31 - 1, -2 ** 31):
            for salt in (0, 5, 1023):
                want = np.asarray(jkeep(jnp.int32(seed), jnp.int32(salt),
                                        jnp.asarray(r), jnp.asarray(c), p))
                got = dropout_keep_mask(seed, salt, torch.from_numpy(r),
                                        torch.from_numpy(c), p)
                assert np.array_equal(got.numpy(), want), (seed, salt)
    if p == 0.0:
        assert want.all()


def test_dropout_keep_salts_every_head():
    """Dropout.keep gives batch row b and query head i the salt b * h + i,
    so the heads of a GQA group differ and so do the batch rows; the
    kernels' arguments are on, the seed's 32 bits, the threshold and the
    scale."""
    drop = Dropout.make(0.5, -7)
    keep = drop.keep(3, 4, 16, 24)
    rows, cols = torch.arange(16)[:, None], torch.arange(24)[None, :]
    for b in range(3):
        for i in range(4):
            assert torch.equal(keep[b, i], dropout_keep_mask(
                -7, b * 4 + i, rows, cols, 0.5))
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep[0, 0], keep[1, 0])
    assert Dropout.c_args(drop) == (1, 2 ** 32 - 7, 2 ** 31, 2.0)
    assert Dropout.c_args(None) == (0, 0, 0, 0.0)
    assert Dropout.make(0.0, None) is None
    with pytest.raises(ValueError, match="requires dropout_seed"):
        Dropout.make(0.1, None)


# ------------------------------------------- entries with dropout vs JAX

CASES = {
    "causal": dict(sq=96, sk=160, causal=True),
    "full": dict(sq=160, sk=96, causal=False),
    "window": dict(sq=128, sk=128, causal=False, window_size=(40, 8)),
    "segments": dict(sq=128, sk=128, causal=True, segments=True),
}


def _inputs(name):
    c = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = _randn(rng, (B, c["sq"], H, D))
    k, v = (_randn(rng, (B, c["sk"], HK, D)) for _ in range(2))
    do = _randn(rng, (B, c["sq"], H, D))
    seg = None
    if c.get("segments"):
        seg = np.sort(rng.integers(0, 3, (B, c["sq"])), 1).astype(np.int32)
    return (q, k, v), do, seg


def _kw(name):
    c = CASES[name]
    return dict(causal=c["causal"], window_size=c.get("window_size", (-1, -1)))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """out and dq/dk/dv of the JAX entry (one call per case)."""
    arrays, do, seg = _inputs(name)
    if seg is None:
        fn = lambda q, k, v: jif.flash_attn_func(  # noqa: E731
            q, k, v, **_kw(name), **DROP)
    else:
        s = jnp.asarray(seg)
        fn = lambda q, k, v: jnp.swapaxes(jif.flash_attention(  # noqa: E731
            *(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), None, s, s,
            **_kw(name), **DROP), 1, 2)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_case(name, dtype=torch.float32):
    arrays, do, seg = _inputs(name)
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    if seg is None:
        out = flash_attn_func(*ins, **_kw(name), **DROP)
    else:
        s = torch.from_numpy(seg)
        out = flash_attention(*(t.transpose(1, 2) for t in ins), None, s, s,
                              **_kw(name), **DROP).transpose(1, 2)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do).to(dtype))
    return out, grads


@pytest.mark.parametrize("name", list(CASES))
def test_dropout_matches_jax(name):
    out, grads = _torch_case(name)
    want, want_grads = _jax_case(name)
    _close(out.detach(), want, 5e-5)
    for g, w in zip(grads, want_grads):
        _close(g, w, 5e-5)


def test_dropout_bf16_meets_the_contract():
    """bf16 forward and gradients (causal, sq < sk, GQA 2) against the fp32
    result (JAX's, within 5e-5 of the port's fp32 reference) within twice
    the bf16 reorder-ops baseline's error under the same keep mask."""
    out, grads = _torch_case("causal", torch.bfloat16)
    want, want_grads = _jax_case("causal")
    (q, k, v), do, _ = _inputs("causal")
    c = CASES["causal"]
    keep = Dropout.make(P, SEED).keep(B, H, c["sq"], c["sk"])
    ins = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    lp, _ = attention_ref(*ins, causal=True, dropout_p=P, dropout_mask=keep,
                          upcast=False, reorder_ops=True)
    lp_grads = torch.autograd.grad(lp, ins, torch.from_numpy(do).bfloat16())
    for got, low, w in zip((out, *grads), (lp, *lp_grads),
                           (want, *want_grads)):
        err = np.abs(got.detach().float().numpy() - w).max()
        err_lp = np.abs(low.detach().float().numpy() - w).max()
        assert err <= 2 * err_lp + 1e-3, (err, err_lp)


def _cu(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _varlen_inputs():
    rng = np.random.default_rng(31)
    cu_q, cu_k = _cu([24, 40, 17]), _cu([32, 40, 29])
    q = _randn(rng, (int(cu_q[-1]), H, D))
    k, v = (_randn(rng, (int(cu_k[-1]), HK, D)) for _ in range(2))
    do = _randn(rng, q.shape)
    return (q, k, v), do, cu_q, cu_k


@functools.lru_cache(maxsize=None)
def _jax_varlen():
    arrays, do, cu_q, cu_k = _varlen_inputs()
    fn = lambda q, k, v: jif.flash_attn_varlen_func(  # noqa: E731
        q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k), 40, 40, causal=True,
        **DROP)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def test_varlen_dropout_matches_jax():
    """Three documents of different q and k lengths, causal (bottom-right
    per document): the rows and columns of the keep mask are the packed
    positions, as in the JAX package."""
    arrays, do, cu_q, cu_k = _varlen_inputs()
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = flash_attn_varlen_func(*ins, torch.from_numpy(cu_q),
                                 torch.from_numpy(cu_k), 40, 40, causal=True,
                                 **DROP)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    want, want_grads = _jax_varlen()
    _close(out.detach(), want, 5e-5)
    for g, w in zip(grads, want_grads):
        _close(g, w, 5e-5)


def test_packed_qkv_dropout_matches_jax():
    """The packed Wqkv entry (the #5 / #6 route): out and the packed dqkv,
    causal, h = hk (salt b * h + head as JAX's fused_heads.py:86-87)."""
    rng = np.random.default_rng(41)
    s, h = 64, 2
    qkv = _randn(rng, (B, s, 3 * h * D))
    do = _randn(rng, (B, s, h * D))
    kw = dict(num_heads=h, num_heads_kv=h, head_dim=D, causal=True, **DROP)
    out, vjp = jax.vjp(lambda x: jfh.packed_qkv_attention(x, **kw),
                       jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    got = tfh.packed_qkv_attention(x, **kw)
    (g,) = torch.autograd.grad(got, x, torch.from_numpy(do))
    _close(got.detach(), np.asarray(out), 5e-5)
    _close(g, np.asarray(vjp(jnp.asarray(do))[0]), 5e-5)


def test_attn_probs_negate_the_dropped_entries():
    """return_attn_probs with dropout: S_dmask as the JAX package's debug
    tensor from the same LSE (the probabilities, dropped entries negated;
    its plain XLA function, not the kernel), and its sign is the keep mask
    wherever a probability is not 0."""
    (q, k, v), _, _ = _inputs("causal")
    _, lse, probs = flash_attn_func(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, return_attn_probs=True,
                                    **DROP)
    want = np.asarray(jif._attn_probs_debug(
        *(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k)),
        jnp.asarray(lse.numpy()), softmax_scale=D ** -0.5, causal=True,
        window_size=(-1, -1), softcap=0.0, dropout_p=P, dropout_seed=SEED))
    _close(probs, want, 1e-5)
    c = CASES["causal"]
    keep = Dropout.make(P, SEED).keep(B, H, c["sq"], c["sk"]).numpy()
    seen = want != 0
    assert np.array_equal((probs.numpy() >= 0)[seen], keep[seen])
    assert (probs.numpy() < 0).any()


# ------------------------------------------------------------------- MHA

@pytest.mark.parametrize("h", [4, 5], ids=["packed", "flash_attention"])
def test_mha_dropout_seed_matches_jax(h):
    """MHA with dropout 0.1 and deterministic=False with an explicit
    dropout_seed, on the packed route (h d = 256) and off it (h d = 320,
    flash_attention), against the JAX MHA on the same weights."""
    b, s = 2, 48
    e = h * D
    rng = np.random.default_rng(h)
    x = _randn(rng, (b, s, e))
    jmha = JMHA(embed_dim=e, num_heads=h, causal=True, dropout=P,
                dtype=jnp.float32)
    params = jmha.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, _ = jmha.apply(params, jnp.asarray(x), deterministic=False,
                         dropout_seed=SEED)
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    mha = MHA(e, h, causal=True, dropout=P, device="cpu")
    mha.load_state_dict({
        "Wqkv.weight": torch.from_numpy(p["Wqkv"]["kernel"].T.copy()),
        "Wqkv.bias": torch.from_numpy(p["Wqkv"]["bias"].copy()),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"].copy())})
    with torch.inference_mode():
        got, _ = mha(torch.from_numpy(x), deterministic=False,
                     dropout_seed=SEED)
        plain, _ = mha(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_mha_draws_its_seed_from_the_generator():
    """No dropout_seed: a seed in [0, 2^31 - 1) from the caller's
    generator (the same as draw_dropout_seed on a generator in the same
    state); neither given raises ValueError, as a missing dropout rng does
    in the JAX package."""
    mha = MHA(128, 2, causal=True, dropout=0.2, device="cpu")
    x = torch.randn(1, 16, 128)
    with torch.inference_mode():
        got, _ = mha(x, deterministic=False,
                     dropout_generator=torch.Generator().manual_seed(9))
        seed = draw_dropout_seed(torch.Generator().manual_seed(9))
        want, _ = mha(x, deterministic=False, dropout_seed=seed)
        assert torch.equal(got, want) and 0 <= seed < 2 ** 31 - 1
        with pytest.raises(ValueError, match="requires a seed"):
            mha(x, deterministic=False)
        mha(x)  # deterministic: no seed needed


# ------------------------------------------------------------ refusals

def test_card_refusals_raise_before_any_work():
    """On the card (meta tensors stand in): dropout with float32 q/k/v or
    beside an attention bias raises NotImplementedError naming what brings
    it (ROADMAP.md), fp8 with dropout the JAX package's ValueError; a
    dropout_p without a seed raises ValueError, on the CPU as well."""
    meta = dict(device="meta")
    f32 = torch.empty(1, 2, 128, 64, **meta)
    bf16 = torch.empty(1, 2, 128, 64, dtype=torch.bfloat16, **meta)
    fp8 = torch.empty(1, 2, 128, 64, dtype=torch.float8_e4m3fn, **meta)
    bias = torch.empty(128, 128, **meta)
    for call in (lambda: flash_attention(f32, f32, f32, **DROP),
                 lambda: flash_attention(bf16, bf16, bf16, bias, **DROP),
                 lambda: blocksparse_attention(
                     f32, f32, f32, torch.ones(1, 1, dtype=torch.int32),
                     block_size=128, **DROP),
                 lambda: tfh.packed_qkv_attention(
                     torch.empty(1, 128, 384, **meta), num_heads=2,
                     num_heads_kv=2, head_dim=64, **DROP)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError, match="fp8"):
        flash_attention(fp8, fp8, fp8, **DROP)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.1)
