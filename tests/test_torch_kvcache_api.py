"""Port parity: `flash_attn_with_kvcache` and `fused_decode_step` against
the JAX package.

The same numpy inputs go through both packages (fp32, so the JAX Pallas
kernels #4, #9, #10/#11 run in interpret mode and the port takes its plain
versions). Outputs agree within 1e-5. The port updates the caches in place
and returns the same objects; their contents equal the caches JAX returns
(fp32 within 1e-6, from rotary's cos/sin rounding; int8 payloads equal but
for rare one-step differences at a rounding boundary, scales within 1e-6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu import flash_attn_with_kvcache as jwith_kvcache
from xhy_flash_attention_tpu.inference import fused_decode_step as jfused
from xhy_flash_attention_tpu.inference.paged import PagedKVCache as JPaged
from xhy_flash_attention_tpu.ops.quant import QuantizedKV as JQuantizedKV
from xhy_flash_attention_tpu.ops.quant import quantize_kv as jquantize_kv
from xhy_flash_attention_tpu_torch import flash_attn_with_kvcache
from xhy_flash_attention_tpu_torch.inference import (
    PagedKVCache,
    fused_decode_step,
)
from xhy_flash_attention_tpu_torch.ops.quant import QuantizedKV, quantize_kv

B, S, H, HK, D = 2, 96, 4, 2, 64
LENS = np.array([40, 9], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _tables(rot):
    inv = 1.0 / (10000.0 ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    f = np.outer(np.arange(S, dtype=np.float32), inv)
    return np.cos(f).astype(np.float32), np.sin(f).astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=atol)


def _quant_close(t, j):
    a, b = t.values.float().numpy(), np.asarray(j.values, np.float32)
    assert np.abs(a - b).max() <= 1.0 and (a != b).mean() < 0.01
    np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales),
                               rtol=1e-6)


@pytest.mark.parametrize("sq,rotary,num_splits", [  # every pair of values
    (1, False, 1), (1, True, 2), (3, True, 1), (3, False, 2)])
def test_dense_append(sq, rotary, num_splits):
    q, kc, vc, kn, vn = _rng_arrays(sq, (B, sq, H, D), (B, S, HK, D),
                                    (B, S, HK, D), (B, sq, HK, D),
                                    (B, sq, HK, D))
    cos, sin = _tables(D // 2) if rotary else (None, None)
    jkw = dict(rotary_cos=None if cos is None else jnp.asarray(cos),
               rotary_sin=None if sin is None else jnp.asarray(sin),
               cache_seqlens=jnp.asarray(LENS), num_splits=num_splits)
    tkw = dict(rotary_cos=None if cos is None else torch.from_numpy(cos),
               rotary_sin=None if sin is None else torch.from_numpy(sin),
               cache_seqlens=torch.from_numpy(LENS), num_splits=num_splits)
    jout, jk, jv = jwith_kvcache(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(kn),
                                 jnp.asarray(vn), **jkw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k2, v2 = flash_attn_with_kvcache(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
        torch.from_numpy(vn), **tkw)
    assert k2 is tk and v2 is tv
    _close(out, jout, 1e-5)
    _close(tk, jk, 1e-6)
    _close(tv, jv, 0)


@pytest.mark.parametrize("num_splits", [1, 2])
def test_quantized_append(num_splits):
    q, kc, vc, kn, vn = _rng_arrays(4, (B, 1, H, D), (B, HK, S, D),
                                    (B, HK, S, D), (B, 1, HK, D),
                                    (B, 1, HK, D))
    jq = [jquantize_kv(jnp.asarray(x), jnp.int8) for x in (kc, vc)]
    tq = [quantize_kv(torch.from_numpy(x), torch.int8) for x in (kc, vc)]
    jout, jk, jv = jwith_kvcache(jnp.asarray(q), *jq, jnp.asarray(kn),
                                 jnp.asarray(vn),
                                 cache_seqlens=jnp.asarray(LENS),
                                 num_splits=num_splits)
    out, k2, v2 = flash_attn_with_kvcache(
        torch.from_numpy(q), *tq, torch.from_numpy(kn), torch.from_numpy(vn),
        cache_seqlens=torch.from_numpy(LENS), num_splits=num_splits)
    assert k2 is tq[0] and v2 is tq[1]
    _close(out, jout, 1e-5)
    _quant_close(k2, jk)
    _quant_close(v2, jv)


def test_batch_idx_and_leftpad_without_append():
    q, kc, vc = _rng_arrays(6, (B, 1, H, D), (B, S, HK, D), (B, S, HK, D))
    for kw in (dict(cache_batch_idx=np.array([1, 0], np.int32)),
               dict(cache_leftpad=np.array([3, 20], np.int32))):
        want = jwith_kvcache(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                             cache_seqlens=jnp.asarray(LENS),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        got = flash_attn_with_kvcache(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            cache_seqlens=torch.from_numpy(LENS),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(got, want, 1e-5)
    with pytest.raises(ValueError):
        flash_attn_with_kvcache(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), k=torch.zeros(1),
                                cache_seqlens=torch.from_numpy(LENS))


def _paged_pair(seed, dtype=None):
    """The same empty-page paged cache in both packages, with lengths LENS
    over pages of 32 tokens, 3 per sequence, in a shuffled order."""
    rng = np.random.default_rng(seed)
    P, ps, npp = 8, 32, 3
    pages = rng.standard_normal((P, HK, 2, ps, D)).astype(np.float32)
    table = (1 + rng.permutation(B * npp)).reshape(B, npp).astype(np.int32)
    t = PagedKVCache(torch.from_numpy(pages.copy()), torch.from_numpy(table),
                     torch.from_numpy(LENS))
    j = JPaged(jnp.asarray(pages), jnp.asarray(table), jnp.asarray(LENS))
    return t, j


@pytest.mark.parametrize("rotary", [False, True])
def test_paged_append(rotary):
    q, kn, vn = _rng_arrays(8, (B, 2, H, D), (B, 2, HK, D), (B, 2, HK, D))
    t, j = _paged_pair(9)
    cos, sin = _tables(D // 2) if rotary else (None, None)
    rot = {} if not rotary else dict(rotary_cos=cos, rotary_sin=sin)
    jout, jc = jwith_kvcache(jnp.asarray(q), j, None, jnp.asarray(kn),
                             jnp.asarray(vn),
                             **{k: jnp.asarray(v) for k, v in rot.items()})
    out, tc = flash_attn_with_kvcache(
        torch.from_numpy(q), t, None, torch.from_numpy(kn),
        torch.from_numpy(vn), **{k: torch.from_numpy(v) for k, v in rot.items()})
    assert tc.kv_pages is t.kv_pages
    _close(out, jout, 1e-5)
    _close(tc.kv_pages, jc.kv_pages, 1e-6)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
    # without k/v: attend as the cache stands
    _close(flash_attn_with_kvcache(torch.from_numpy(q), tc, None),
           jwith_kvcache(jnp.asarray(q), jc, None), 1e-5)


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_fused_decode_step(kind):
    q, kn, vn, kc, vc = _rng_arrays(12, (B, 1, H, D), (B, HK, 1, D),
                                    (B, HK, 1, D), (B, HK, S, D),
                                    (B, HK, S, D))
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    lens = None if kind == "paged" else LENS
    if kind == "paged":
        tcache, jcache = _paged_pair(13)
    elif kind == "int8":
        tcache = tuple(quantize_kv(torch.from_numpy(x), torch.int8)
                       for x in (kc, vc))
        jcache = tuple(jquantize_kv(jnp.asarray(x), jnp.int8)
                       for x in (kc, vc))
    else:
        tcache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
        jcache = (jnp.asarray(kc), jnp.asarray(vc))
    jout, jnew = jfused(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                        jcache, None if lens is None else jnp.asarray(lens),
                        jnp.asarray(inv), softmax_scale=D ** -0.5)
    out, tnew = fused_decode_step(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tcache, None if lens is None else torch.from_numpy(lens),
        torch.from_numpy(inv), softmax_scale=D ** -0.5)
    _close(out, jout, 1e-5)
    if kind == "paged":
        assert tnew.kv_pages is tcache.kv_pages
        _close(tnew.kv_pages, jnew.kv_pages, 1e-6)
        assert tnew.lengths.tolist() == (LENS + 1).tolist()
    elif kind == "int8":
        assert tnew is tcache
        for t, j in zip(tnew, jnew):
            _quant_close(t, j)
    else:
        assert tnew is tcache
        for t, j in zip(tnew, jnew):
            _close(t, j, 1e-6)
