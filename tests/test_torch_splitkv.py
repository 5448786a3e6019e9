"""Port parity: split-KV decode, the partial merge and the extended
`flash_decode` against the JAX package.

* `flash_decode_splitkv` with 1, 2 and 3 splits over fp32 and int8
  caches, and 3 over e4m3 (fp32 queries), agrees with JAX (Pallas kernel
  #9 in interpret mode) within 1e-5; its per-split partials (normalised
  out, m, l) agree with JAX's within 1e-5 wherever a split sees a key.
* `merge_attention_partials` equals a softmax over the union (1e-6).
* `num_splits_heuristic` gives JAX's counts.
* `flash_decode` with a QuantizedKV cache, kv_batch_idx and leftpad_k
  agrees with JAX's kernel #4 within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.inference import combine as jcombine
from xhy_flash_attention_tpu.ops.flash_attention.decode_kernel import (
    flash_decode as jflash_decode,
)
from xhy_flash_attention_tpu.ops.quant import quantize_kv as jquantize_kv
from xhy_flash_attention_tpu_torch.inference import combine
from xhy_flash_attention_tpu_torch.ops.flash_attention.decode_kernel import (
    flash_decode,
)
from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv

B, H, HK, D, S = 2, 4, 2, 64, 200
KINDS = {"fp32": None, "int8": (jnp.int8, torch.int8),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, kind, sq=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if KINDS[kind] is not None:
        jdt, tdt = KINDS[kind]
        tk, tv = quantize_kv(tk, tdt), quantize_kv(tv, tdt)
        jk, jv = jquantize_kv(jk, jdt), jquantize_kv(jv, jdt)
    return q, (tk, tv), (jk, jv)


@pytest.mark.parametrize("num_splits,kind", [
    (1, "fp32"), (2, "fp32"), (3, "fp32"), (1, "int8"), (2, "int8"),
    (3, "int8"), (3, "e4m3")])
def test_splitkv_matches_jax(num_splits, kind):
    q, (tk, tv), (jk, jv) = _inputs(num_splits, kind)
    lengths = np.array([S, 77], np.int32)
    kw = dict(softmax_scale=D ** -0.5, num_splits=num_splits, block_k=32)
    want = jcombine.flash_decode_splitkv(jnp.asarray(q), jk, jv,
                                         jnp.asarray(lengths), **kw)
    got = combine.flash_decode_splitkv(torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(lengths), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_splitkv_partials_match_jax(kind):
    q, (tk, tv), (jk, jv) = _inputs(5, kind, sq=2)
    lengths = np.array([150, 40], np.int32)
    kw = dict(softmax_scale=D ** -0.5, window_size=(60, -1), softcap=4.0)
    # JAX cuts S=200 into 4 blocks of 64 (after padding), 2 per split
    outs, ms, ls = jcombine._splitkv_raw(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), num_splits=2,
        block_k=64, **kw)
    rows = 2 * H // HK
    got = combine.splitkv_partials_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(lengths),
        kw["softmax_scale"], 2, 128, kw["window_size"], kw["softcap"])
    l_want = np.asarray(ls)[:, :, :, :rows, 0]
    seen = l_want > 0
    assert seen.any() and not seen.all()  # some splits see nothing
    np.testing.assert_allclose(got[2].numpy(), l_want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1].numpy()[seen],
                               np.asarray(ms)[:, :, :, :rows, 0][seen],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(outs)[:, :, :, :rows], rtol=0,
                               atol=1e-5)


def test_merge_partials_is_softmax_partition():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((8, 64)).astype(np.float32)
    vv = rng.standard_normal((64, 16)).astype(np.float32)
    outs, ms, ls = [], [], []
    for part in (slice(0, 24), slice(24, 64)):
        m = s[:, part].max(-1, keepdims=True)
        p = np.exp(s[:, part] - m)
        outs.append(p / p.sum(-1, keepdims=True) @ vv[part])
        ms.append(m)
        ls.append(p.sum(-1, keepdims=True))
    out, _, l = combine.merge_attention_partials(
        *(torch.from_numpy(np.stack(x)) for x in (outs, ms, ls)))
    want = torch.softmax(torch.from_numpy(s), -1) @ torch.from_numpy(vv)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-6)
    jout, _, jl = jcombine.merge_attention_partials(
        *(jnp.asarray(np.stack(x)) for x in (outs, ms, ls)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-6)


def test_num_splits_heuristic_matches_jax():
    for args in ((1, 1, 4096, 512), (2, 8, 2080, 512), (1, 1, 100, 512),
                 (1, 1, 8192, 1024)):
        assert combine.num_splits_heuristic(*args) == \
            jcombine.num_splits_heuristic(*args)
    # on the card the SM count replaces the TPU's two cores
    assert combine.num_splits_heuristic(2, 8, 2080, 512, num_cores=132) == 5


@pytest.mark.parametrize("option,kind", [
    ("plain", "fp32"), ("plain", "int8"), ("plain", "e4m3"),
    ("kv_batch_idx", "fp32"), ("kv_batch_idx", "int8"),
    ("leftpad_k", "fp32"), ("leftpad_k", "e4m3")])
def test_flash_decode_options_match_jax(option, kind):
    q, (tk, tv), (jk, jv) = _inputs(11, kind, sq=2)
    lengths = np.array([120, 33], np.int32)
    extra = {"plain": {}, "kv_batch_idx": {"kv_batch_idx": [1, 1]},
             "leftpad_k": {"leftpad_k": [7, 50]}}[option]
    kw = dict(softmax_scale=D ** -0.5, window_size=(90, -1))
    want = jflash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths), **kw,
                         **{k: jnp.asarray(v, jnp.int32)
                            for k, v in extra.items()})
    got = flash_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(lengths),
                       **kw, **{k: torch.tensor(v, dtype=torch.int32)
                                for k, v in extra.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
