"""Port parity: sliding windows, segment ids, q/kv positions, the varlen and
kv-packed entry points, bert_padding and GPTModel(segment_ids=...) against
the JAX package.

The same numpy inputs (fp32, from a seed) go through the JAX package's
functions (Pallas kernels in interpret mode on the CPU) and the port's
(plain versions on CPU tensors). Tolerances, relative to each tensor's
largest entry: outputs and the finite LSE 1e-5, gradients against
``jax.vjp`` 5e-5 (two fp32 computations of the same formulas that differ
in the order of their sums, as tests/test_torch_bwd.py); rows that see no
key must give out 0 and LSE +inf on both sides; the S_dmask debug
probabilities 1e-5; bert_padding's integer outputs bit for bit and its
packed values exactly; model logits 1e-4 absolute (tests/test_torch_model.py).
Each JAX call serves every check of its case, and torch runs on one thread
(many tiny ops are slow when six test workers share the cores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu import bert_padding as jbp
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.llama import (
    llama_config_to_gpt_config as jllama_config,
)
from xhy_flash_attention_tpu.ops.flash_attention import interface as jif
from xhy_flash_attention_tpu.ops.flash_attention import reference as jref
from xhy_flash_attention_tpu_torch import (
    BlockSizes,
    GPTLMHeadModel,
    bert_padding as tbp,
    llama_config_to_gpt_config,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import interface as tif
from xhy_flash_attention_tpu_torch.ops.flash_attention import reference as tref

B, H, HK, D = 2, 4, 2, 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _close_lse(got, want, what=""):
    """Same empty rows (+inf) on both sides, the finite LSE within 1e-5."""
    got, want = got.detach().numpy(), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    assert np.all(np.isposinf(got[~fin])), what
    _close(got[fin], want[fin], 1e-5, what)


def _attention_case(rng, sq, sk, j_fn, t_fn, check_empty=False):
    """q (B, H, sq, D), k/v (B, HK, sk, D) and an output cotangent through
    ``j_fn`` / ``t_fn`` (each (q, k, v) -> (out, lse)): out, LSE and the
    gradients of out against jax.vjp."""
    arrays = [_randn(rng, (B, H, sq, D)), _randn(rng, (B, HK, sk, D)),
              _randn(rng, (B, HK, sk, D))]
    do = _randn(rng, (B, H, sq, D))
    (jout, jlse), vjp = jax.vjp(j_fn, *map(jnp.asarray, arrays))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout, tlse = t_fn(*ins)
    tgrads = torch.autograd.grad(tout, ins, torch.from_numpy(do))
    _close(tout, jout, 1e-5, "out")
    _close_lse(tlse, jlse, "lse")
    for g, w, name in zip(tgrads, jgrads, "qkv"):
        _close(g, w, 5e-5, f"d{name}")
    if check_empty:
        empty = ~np.isfinite(np.asarray(jlse))
        assert empty.any(), "the case should hold rows with no key"
        assert not tout.detach().numpy()[empty].any()
    return tout, tlse


WINDOWS = {  # causal, window, sq, sk
    "causal-left": (True, (24, 0), 160, 160),
    "left-only": (False, (30, -1), 160, 160),
    "right-only": (False, (-1, 20), 160, 160),
    "both-sq<sk": (False, (17, 9), 96, 160),
    "causal-sq>sk": (True, (40, 0), 160, 96),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_window_matches_jax(case):
    """Sliding windows, causal and not, left only, right only and both,
    sq != sk both ways (sq > sk: rows with no key), GQA: forward, LSE and
    gradients."""
    causal, window, sq, sk = WINDOWS[case]
    kw = dict(causal=causal, window_size=window, return_lse=True)
    _attention_case(np.random.default_rng(len(case)), sq, sk,
                    lambda q, k, v: jif.flash_attention(q, k, v, **kw),
                    lambda q, k, v: tif.flash_attention(q, k, v, **kw),
                    check_empty=case == "causal-sq>sk")


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_match_jax(causal):
    """Arbitrary (non-monotone) segment ids with padded tails of id 0 (the
    queries' and the keys' of different lengths), sq != sk: rows whose id
    appears among no visible key give 0 and LSE +inf."""
    rng = np.random.default_rng(11 + causal)
    sq, sk = 144, 176
    qs = rng.integers(1, 4, (B, sq)).astype(np.int32)
    ks = rng.integers(1, 4, (B, sk)).astype(np.int32)
    qs[:, -20:], ks[:, -33:] = 0, 5
    qs[0, :9] = 7  # an id no key carries
    kw = dict(causal=causal, return_lse=True)
    _attention_case(
        rng, sq, sk,
        lambda q, k, v: jif.flash_attention(q, k, v, None, jnp.asarray(qs),
                                            jnp.asarray(ks), **kw),
        lambda q, k, v: tif.flash_attention(q, k, v, None,
                                            torch.from_numpy(qs),
                                            torch.from_numpy(ks), **kw),
        check_empty=True)


def test_positions_and_segments_match_jax():
    """q/kv positions (a ring shard's offsets: keys at 2t, queries at 2t +
    40) with a causal left window on them, ANDed with segment ids."""
    rng = np.random.default_rng(3)
    s = 128
    kpos = np.tile(2 * np.arange(s, dtype=np.int32), (B, 1))
    qpos = kpos + 40
    seg = np.sort(rng.integers(1, 4, (B, s)), -1).astype(np.int32)
    kw = dict(causal=True, window_size=(50, -1), return_lse=True)
    j = [jnp.asarray(a) for a in (seg, seg, qpos, kpos)]
    t = [torch.from_numpy(a) for a in (seg, seg, qpos, kpos)]
    _attention_case(
        rng, s, s,
        lambda q, k, v: jif.flash_attention(
            q, k, v, None, j[0], j[1], q_positions=j[2], kv_positions=j[3],
            **kw),
        lambda q, k, v: tif.flash_attention(
            q, k, v, None, t[0], t[1], q_positions=t[2], kv_positions=t[3],
            **kw))


VARLEN = {  # lens_q, lens_k (JAX tests/test_flash_attn.py:314 and :345)
    "decoupled": ([37, 100, 19], [64, 80, 150]),
    "shared": ([100, 170, 50], [100, 170, 50]),
}


@pytest.mark.parametrize("case,causal,window", [
    ("decoupled", True, (-1, -1)), ("decoupled", False, (-1, -1)),
    ("shared", True, (31, 0)), ("decoupled", True, (25, -1))])
def test_varlen_matches_jax(case, causal, window):
    """flash_attn_varlen_func over packings with cu_seqlens_q !=
    cu_seqlens_k (bottom-right aligned per sequence by positions; lk < lq
    leaves rows with no key under causal), with 6 padding tokens past
    cu_seqlens_q[-1] and 4 past cu_seqlens_k[-1]; a sliding window on the
    local positions. Out, LSE (h, total_q) and gradients against
    jax.vjp."""
    lens_q, lens_k = VARLEN[case]
    rng = np.random.default_rng(len(case) + causal)
    cu_q = np.cumsum([0] + lens_q).astype(np.int32)
    cu_k = np.cumsum([0] + lens_k).astype(np.int32)
    tq, tk = int(cu_q[-1]) + 6, int(cu_k[-1]) + 4
    arrays = [_randn(rng, (tq, H, D)), _randn(rng, (tk, HK, D)),
              _randn(rng, (tk, HK, D))]
    do = _randn(rng, (tq, H, D))
    kw = dict(causal=causal, window_size=window, return_lse=True)

    def jfn(q, k, v):
        return jif.flash_attn_varlen_func(q, k, v, jnp.asarray(cu_q),
                                          jnp.asarray(cu_k), 1, 1, **kw)
    (jout, jlse), vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout, tlse = tif.flash_attn_varlen_func(
        *ins, torch.from_numpy(cu_q), torch.from_numpy(cu_k), 1, 1, **kw)
    tgrads = torch.autograd.grad(tout, ins, torch.from_numpy(do))
    _close(tout, jout, 1e-5, "out")
    _close_lse(tlse, jlse, "lse")
    for g, w, name in zip(tgrads, jgrads, "qkv"):
        _close(g, w, 5e-5, f"d{name}")
    if case == "decoupled" and causal:
        assert np.isinf(np.asarray(jlse)).any()


def test_segment_ids_from_cu_seqlens_bit_exact():
    """searchsorted(side="right"), tokens past cu_seqlens[-1] included."""
    cu = np.array([0, 3, 3, 10, 17], np.int32)
    got = tif._segment_ids_from_cu_seqlens(torch.from_numpy(cu), 22)
    want = jif._segment_ids_from_cu_seqlens(jnp.asarray(cu), 22)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_entry_points_match_jax():
    """flash_attn_kvpacked_func, flash_attn_func,
    flash_attn_varlen_qkvpacked_func and flash_attn_varlen_kvpacked_func
    with return_attn_probs (out, LSE and the S_dmask debug probabilities),
    and the varlen entry with return_lse alone: against the JAX package's
    same entries."""
    rng = np.random.default_rng(21)
    s = 96
    q, do = _randn(rng, (B, s, H, D)), _randn(rng, (B, s, H, D))
    kv = _randn(rng, (B, s, 2, HK, D))
    kw = dict(causal=True, window_size=(40, 0), return_attn_probs=True)
    j = jif.flash_attn_kvpacked_func(jnp.asarray(q), jnp.asarray(kv), **kw)
    t = tif.flash_attn_kvpacked_func(torch.from_numpy(q),
                                     torch.from_numpy(kv), **kw)
    f = tif.flash_attn_func(torch.from_numpy(q), torch.from_numpy(kv[:, :, 0]),
                            torch.from_numpy(kv[:, :, 1]), **kw)
    for got, same, want, name in zip(t, f, j, ("out", "lse", "probs")):
        _close(got, want, 1e-5, f"kvpacked {name}")
        assert torch.equal(got, same)
    cu = np.array([0, 40, 41, 150, 192], np.int32)
    qkv = _randn(rng, (192, 3, H, D))
    qkv[:, 1:, HK:] = 0  # unused heads of k/v for the kv-packed entry
    kw = dict(causal=False, window_size=(-1, 30), return_attn_probs=True)
    j = jif.flash_attn_varlen_qkvpacked_func(jnp.asarray(qkv),
                                             jnp.asarray(cu), 109, **kw)
    t = tif.flash_attn_varlen_qkvpacked_func(torch.from_numpy(qkv),
                                             torch.from_numpy(cu), 109, **kw)
    for got, want, name in zip(t, j, ("out", "lse", "probs")):
        if name == "lse":
            _close_lse(got, want, "varlen qkvpacked lse")
        else:
            _close(got, want, 1e-5, f"varlen qkvpacked {name}")
    kvp = np.ascontiguousarray(qkv[:, 1:, :HK])
    kw = dict(causal=True, return_attn_probs=True)
    j = jif.flash_attn_varlen_kvpacked_func(
        jnp.asarray(qkv[:, 0]), jnp.asarray(kvp), jnp.asarray(cu),
        jnp.asarray(cu), 109, 109, **kw)
    t = tif.flash_attn_varlen_kvpacked_func(
        torch.from_numpy(qkv[:, 0]), torch.from_numpy(kvp),
        torch.from_numpy(cu), torch.from_numpy(cu), 109, 109, **kw)
    for got, want, name in zip(t, j, ("out", "lse", "probs")):
        _close(got, want, 1e-5, f"varlen kvpacked {name}")
    out, lse = tif.flash_attn_varlen_func(
        torch.from_numpy(qkv[:, 0]), torch.from_numpy(kvp[:, 0]),
        torch.from_numpy(kvp[:, 1]), torch.from_numpy(cu),
        torch.from_numpy(cu), 109, 109, causal=True, return_lse=True)
    assert torch.equal(out, t[0]) and torch.equal(lse, t[1])


def test_block_sizes_stand_in():
    """BlockSizes carries the JAX field names, reports the CUDA tiles per
    head dim, and is accepted and ignored by the entry points."""
    import dataclasses
    from xhy_flash_attention_tpu.ops.flash_attention.common import (
        BlockSizes as JBlockSizes)
    assert [f.name for f in dataclasses.fields(BlockSizes)] == \
        [f.name for f in dataclasses.fields(JBlockSizes)]
    assert BlockSizes.for_shape(2048, 2048, 64) == BlockSizes(
        128, 128, 64, 128, 128, 128)
    assert BlockSizes.for_shape(100, 300, 128).block_k_dq == 64
    q = torch.randn(1, 64, 2, 64)
    assert torch.equal(
        tif.flash_attn_func(q, q, q, causal=True,
                            block_sizes=BlockSizes(block_q=512)),
        tif.flash_attn_func(q, q, q, causal=True))


@pytest.mark.parametrize("static_total", [None, 13])
def test_bert_padding_matches_jax(static_total):
    """unpad_input / pad_input / index_* against the JAX package: indices,
    cu_seqlens, max_seqlen and segment ids bit for bit, the packed and
    re-padded values exactly; generate_qkv_segment_ids bit for bit."""
    rng = np.random.default_rng(5)
    b, s = 3, 9
    x = _randn(rng, (b, s, 4, 2))
    mask = rng.random((b, s)) < 0.6
    mask[1] = False  # an empty sequence
    j = jbp.unpad_input(jnp.asarray(x), jnp.asarray(mask), static_total)
    t = tbp.unpad_input(torch.from_numpy(x), torch.from_numpy(mask),
                        static_total)
    for got, want in zip(t, j):
        got = got.numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype or got.dtype.kind == want.dtype.kind
        np.testing.assert_array_equal(got, want)
    packed, indices = t[0], t[1]
    if static_total is None:
        np.testing.assert_array_equal(
            tbp.pad_input(packed, indices, b, s).numpy(),
            np.asarray(jbp.pad_input(j[0], j[1], b, s)))
        np.testing.assert_array_equal(
            tbp.pad_input(packed, indices, b, s).numpy(), x * mask[..., None, None])
    flat = torch.from_numpy(x.reshape(b * s, 4, 2))
    got, res = tbp.index_first_axis_residual(flat, indices)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jbp.index_first_axis(jnp.asarray(x.reshape(b * s, 4, 2)), j[1])))
    assert res is flat
    np.testing.assert_array_equal(
        tbp.index_put_first_axis(got, indices, b * s).numpy(),
        np.asarray(jbp.index_put_first_axis(
            jnp.asarray(got.numpy()), j[1], b * s)))
    qm, km = rng.random((b, 7)) < 0.5, rng.random((b, 5)) < 0.5
    for tm, jm in ((None, None), ((qm, km), (qm, km))):
        got = tref.generate_qkv_segment_ids(
            *(None, None) if tm is None else map(torch.from_numpy, tm),
            b, 7, 5)
        want = jref.generate_qkv_segment_ids(
            *(None, None) if jm is None else map(jnp.asarray, jm), b, 7, 5)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
            assert g_.dtype == torch.int32


def test_gpt_segment_ids_match_jax():
    """GPTModel(segment_ids=...) (packed documents in one row, and a padded
    tail of id 0) against the JAX model on the same weights: fp32 logits
    within 1e-4; the ids change the logits (they reach the attention)."""
    import types
    cfg = types.SimpleNamespace(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        rope_theta=10000.0, rms_norm_eps=1e-5)
    rng = np.random.default_rng(9)
    s = 80
    ids = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    seg = np.repeat(np.array([[1, 2, 3, 4], [1, 1, 2, 0]], np.int32), s // 4,
                    axis=1)
    jmodel = JGPTLMHeadModel(jllama_config(cfg))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    want, _ = jmodel.apply(params, jnp.asarray(ids),
                           segment_ids=jnp.asarray(seg))
    port_cfg = llama_config_to_gpt_config(cfg)
    tmodel = GPTLMHeadModel(port_cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, port_cfg))
    with torch.inference_mode():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        segment_ids=torch.from_numpy(seg))
        plain, _ = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert not torch.allclose(got[:, s // 4:], plain[:, s // 4:], atol=1e-3)
