"""Port parity: the paged KV cache against the JAX package.

The same numpy pages, page table and lengths go through JAX's
`append_paged_kv` / `paged_flash_decode` (Pallas kernels #10 and #11 in
interpret mode) and the port's (the plain version on CPU tensors).

* `append_paged_kv` is bit-exact: pages (trash page included), linear
  scales (writes past the buffer dropped) and lengths, for fp32, int8 and
  e4m3 pages, one and several new tokens, an empty (inactive) slot.
* `paged_flash_decode` on both routes (d = 128 with several pages per
  sequence takes the chunked kernel, one page per sequence or d = 64 the
  one-page kernel), sq of 1 and 3, a zero-length slot, window and softcap:
  fp32 and int8 / e4m3 pages with fp32 queries within 1e-5; bf16 within
  one bf16 unit of the largest output (P is rounded to bf16 for P.V on
  both sides, in another summation order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.inference.paged import PagedKVCache as JPaged
from xhy_flash_attention_tpu.inference.paged import append_paged_kv as jappend
from xhy_flash_attention_tpu.inference.paged import (
    paged_flash_decode as jpaged_decode,
)
from xhy_flash_attention_tpu.ops.quant import quantize_kv as jquantize_kv
from xhy_flash_attention_tpu_torch.inference import paged
from xhy_flash_attention_tpu_torch.inference.paged import (
    PagedKVCache,
    append_paged_kv,
    paged_flash_decode,
)
from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}
QUANT = (torch.int8, torch.float8_e4m3fn)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x.astype(np.float32)


def _caches(rng, b, hk, d, ps, npp, lengths, dtype):
    """The same paged cache in both packages: random pages taken in a
    shuffled order (page 0 unused, the last page a trash page)."""
    P = b * npp + 2
    k = rng.standard_normal((P, hk, ps, d)).astype(np.float32)
    v = rng.standard_normal((P, hk, ps, d)).astype(np.float32)
    table = (1 + rng.permutation(b * npp)).reshape(b, npp).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if dtype in QUANT:
        tq = [quantize_kv(x, dtype) for x in (tk, tv)]
        jq = [jquantize_kv(x, JDT[dtype]) for x in (jk, jv)]
        t = PagedKVCache.from_kv(
            tq[0].values, tq[1].values, torch.from_numpy(table),
            torch.from_numpy(lens),
            *[x.scales.reshape(P, hk, 1, ps) for x in tq])
        j = JPaged.from_kv(
            jq[0].values, jq[1].values, jnp.asarray(table), jnp.asarray(lens),
            *[x.scales.reshape(P, hk, 1, ps) for x in jq])
    else:
        t = PagedKVCache.from_kv(tk.to(dtype), tv.to(dtype),
                                 torch.from_numpy(table),
                                 torch.from_numpy(lens))
        j = JPaged.from_kv(jk.astype(JDT[dtype]), jv.astype(JDT[dtype]),
                           jnp.asarray(table), jnp.asarray(lens))
    return t, j


def _assert_same_cache(t, j):
    np.testing.assert_array_equal(_np(t.kv_pages), _np(j.kv_pages))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    if t.kv_scales is not None:
        np.testing.assert_array_equal(t.kv_scales.numpy(),
                                      np.asarray(j.kv_scales))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("sq", [1, 3])
def test_append_paged_kv_is_bit_exact(dtype, sq):
    rng = np.random.default_rng(sq)
    b, hk, d, ps, npp = 4, 2, 16, 8, 3
    # slot 1 empty (inactive: its append goes to its table's pages but its
    # length stays 0); slot 3 at capacity (its writes past the scale buffer
    # are dropped)
    t, j = _caches(rng, b, hk, d, ps, npp, [5, 0, 16, npp * ps - 1], dtype)
    k = rng.standard_normal((b, hk, sq, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sq, d)).astype(np.float32)
    lengths_before = t.lengths.clone()
    t2 = append_paged_kv(t, torch.from_numpy(k), torch.from_numpy(v))
    j2 = jappend(j, jnp.asarray(k), jnp.asarray(v))
    _assert_same_cache(t2, j2)
    assert t2.kv_pages is t.kv_pages           # pages written in place
    assert torch.equal(t.lengths, lengths_before)  # lengths are new
    assert t2.lengths.tolist() == [5 + sq, 0, 16 + sq, npp * ps - 1 + sq]


def test_append_with_num_valid_and_active():
    """Explicit num_valid (JAX chunked-prefill form) is bit-exact; the
    port's `active` flag counts an empty slot's first chunk."""
    rng = np.random.default_rng(7)
    b, hk, d, ps, npp, sq = 2, 2, 16, 8, 3, 4
    t, j = _caches(rng, b, hk, d, ps, npp, [0, 6], torch.float32)
    k = rng.standard_normal((b, hk, sq, d)).astype(np.float32)
    nv = np.array([4, 2], np.int32)
    t2 = append_paged_kv(t, torch.from_numpy(k), torch.from_numpy(k),
                         num_valid=torch.from_numpy(nv))
    j2 = jappend(j, jnp.asarray(k), jnp.asarray(k), num_valid=jnp.asarray(nv))
    _assert_same_cache(t2, j2)
    act = dataclasses.replace(t, active=torch.tensor([True, True]))
    assert append_paged_kv(act, torch.from_numpy(k),
                           torch.from_numpy(k)).lengths.tolist() == [4, 10]


ROUTES = [  # (d, npp, ps): route
    (128, 4, 16),  # chunked
    (64, 4, 16),   # page (d % 128 != 0)
    (128, 1, 32),  # page (one page per sequence)
]


F32, BF16, I8, E4M3 = (torch.float32, torch.bfloat16, torch.int8,
                       torch.float8_e4m3fn)
CASES = [  # (route, sq, page dtype): every route meets sq 1 and 3 and
    # fp32 and a quantized page type
    (ROUTES[0], 1, F32), (ROUTES[0], 3, F32), (ROUTES[0], 1, BF16),
    (ROUTES[0], 3, I8), (ROUTES[0], 1, E4M3), (ROUTES[1], 3, F32),
    (ROUTES[1], 1, I8), (ROUTES[2], 1, F32),
    (ROUTES[2], 3, E4M3)]


@pytest.mark.parametrize("route,sq,dtype", CASES)
def test_paged_flash_decode_matches_jax(route, sq, dtype):
    d, npp, ps = route
    rng = np.random.default_rng(d + npp + sq)
    b, h, hk = 3, 4, 2
    cap = npp * ps
    t, j = _caches(rng, b, hk, d, ps, npp, [cap, 0, cap // 2 + 3], dtype)
    window, softcap = ((cap // 3, -1), 5.0) if sq == 3 else ((-1, -1), 0.0)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    qdt = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    kw = dict(softmax_scale=d ** -0.5, window_size=window, softcap=softcap)
    want = jpaged_decode(jnp.asarray(q, JDT[qdt]), j, **kw)
    counts = (paged.paged_decode_chunked.launches,
              paged.paged_decode_page.launches)
    got = paged_flash_decode(torch.from_numpy(q).to(qdt), t, **kw)
    # CPU tensors take the plain version: no launch counted
    assert (paged.paged_decode_chunked.launches,
            paged.paged_decode_page.launches) == counts
    want = np.asarray(want.astype(jnp.float32))
    assert not got[1].float().abs().any()  # the empty slot gives zeros
    if qdt == torch.bfloat16:
        tol = 2.0 ** -7 * np.abs(want).max() + 1e-6
    else:
        tol = 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_routes_follow_the_jax_rule(monkeypatch):
    """paged_flash_decode picks the chunked entry exactly when the JAX
    package picks its chunked kernel (paged.py:518)."""
    seen = []
    for name in ("paged_decode_chunked", "paged_decode_page"):
        monkeypatch.setattr(paged, name,
                            lambda q, c, _n=name, **kw: seen.append(_n))
    for d, npp, ps in ROUTES:
        t = PagedKVCache.create(4, 1, ps, d, 1, npp, torch.float32,
                                device="cpu")
        paged.paged_flash_decode(torch.zeros(1, 1, 2, d), t)
    assert seen == ["paged_decode_chunked", "paged_decode_page",
                    "paged_decode_page"]
