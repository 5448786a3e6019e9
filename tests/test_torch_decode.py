"""Port parity: decode attention against the JAX package.

The same numpy inputs go through JAX `flash_decode` (Pallas kernel in
interpret mode on the CPU) and the port's `flash_decode` / `decode_attention`
(the plain math on CPU tensors), with ragged per-sample lengths, one or two
new tokens, GQA, sliding window and softcap. fp32 agrees within 1e-5.
The CUDA kernel's launch plan (clusters of CTAs, each over a chunk of the
visible keys) is checked here too: its chunks cover the keys once, and
their partials merge to the whole.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.decode import (
    _decode_attention_xla as jdecode_xla,
)
from xhy_flash_attention_tpu.ops.flash_attention.decode_kernel import (
    flash_decode as jflash_decode,
)
from xhy_flash_attention_tpu_torch.inference import combine
from xhy_flash_attention_tpu_torch.ops.decode import decode_attention
from xhy_flash_attention_tpu_torch.ops.flash_attention import decode_kernel
from xhy_flash_attention_tpu_torch.ops.flash_attention.common import NEG_INF

B, H, HK, D, S = 2, 4, 2, 64, 256
LENGTHS = np.array([200, 77], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(sq, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("softcap", [0.0, 10.0])
@pytest.mark.parametrize("window", [(-1, -1), (48, -1)])
@pytest.mark.parametrize("sq", [1, 2])
def test_flash_decode_matches_jax(sq, window, softcap):
    q, kc, vc = _inputs(sq, seed=sq)
    want = jflash_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(LENGTHS),
        softmax_scale=D ** -0.5, window_size=window, softcap=softcap)
    got = decode_kernel.flash_decode(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(LENGTHS), softmax_scale=D ** -0.5,
        window_size=window, softcap=softcap)
    assert got.shape == (B, sq, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("sq", [1, 2])
def test_decode_attention_matches_jax_math_path(sq):
    q, kc, vc = _inputs(sq, seed=10 + sq)
    want = jdecode_xla(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray(LENGTHS), D ** -0.5)
    got = decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(LENGTHS), D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_cpu_cache_takes_the_plain_version():
    q, kc, vc = _inputs(1, seed=3)
    before = decode_kernel.flash_decode.launches
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(LENGTHS))
    got = decode_kernel.flash_decode(*args, softmax_scale=0.125)
    assert torch.equal(got, decode_kernel.flash_decode_ref(*args, 0.125))
    assert decode_kernel.flash_decode.launches == before


@pytest.mark.parametrize("kw", [dict(kv_batch_idx=np.array([1, 0], np.int32)),
                                dict(leftpad_k=np.array([0, 3], np.int32))])
def test_serving_slice_options_raise(kw):
    """kv_batch_idx and leftpad_k, which raised before the paged-serving
    slice, now agree with the JAX kernel within 1e-5 (fp32)."""
    q, kc, vc = _inputs(1, seed=4)
    lengths = np.array([150, 77], np.int32)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(lengths), softmax_scale=0.125,
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(lengths),
                           0.125, **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_quantized_cache_raises():
    """A quantized payload comes as a QuantizedKV with its scales; a bare
    int8 tensor raises."""
    q, kc, vc = _inputs(1, seed=5)
    with pytest.raises(TypeError, match="quantized"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(kc).to(torch.int8),
                         torch.from_numpy(vc).to(torch.int8),
                         torch.from_numpy(LENGTHS), 0.125)


# ---- the launch plan of csrc/flash_decode.cu: clusters and their chunks

@pytest.mark.parametrize("b,hk,S,splits,split_len,cluster", [
    (2, 8, 2080, 1, 0, 8),      # request A: 16 (batch, kv head) pairs
    (2, 8, 1024, 1, 0, 8),      # request B
    (8, 8, 8192, 1, 0, 2),      # the JAX package's headline decode shape
    (2, 8, 2080, 5, 512, 1),    # split-KV at A, bf16: 80 CTAs already
    (2, 8, 2080, 3, 1024, 2),   # split-KV at A, int8
    (1, 1, 100, 1, 0, 2),       # two tiles: at most two CTAs
    (64, 8, 4096, 1, 0, 1),     # a full grid without clusters
])
def test_decode_launch_plan(b, hk, S, splits, split_len, cluster):
    got, chunk_len = decode_kernel.decode_launch_plan(b, hk, S, splits,
                                                      split_len, 132)
    assert got == cluster
    assert got in decode_kernel.CLUSTER_SIZES
    span = min(S, split_len) if split_len else S
    tiles = -(-span // decode_kernel.TILE)
    assert chunk_len == -(-tiles // got) * decode_kernel.TILE
    assert got * chunk_len >= span


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("start,stop,first,split_len", [
    (0, 2080, 0, 0), (37, 1000, 0, 0), (1000, 1003, 0, 0), (5, 5, 0, 0),
    (130, 512, 0, 512), (512, 700, 512, 512), (1100, 1536, 1024, 512)])
def test_cta_chunks_cover_each_split_once(start, stop, first, split_len,
                                          cluster):
    """The CTAs' chunks are tile-aligned from the split's first key, do not
    overlap, and cover the visible keys [start, stop) of the split."""
    chunks = [decode_kernel.cta_chunk(start, stop, first, r, cluster)
              for r in range(cluster)]
    covered = []
    for lo, hi in chunks:
        assert lo <= hi <= stop
        if lo < hi:
            assert (lo - first) % decode_kernel.TILE == 0
            assert hi == stop or (hi - first) % decode_kernel.TILE == 0
        covered += range(lo, hi)
    assert len(covered) == len(set(covered))
    assert set(range(start, stop)) <= set(covered)
    assert all(k >= first and (not split_len or k < first + split_len)
               for k in covered)


def _visible_range(length, lp, sq, window, S):
    """[start, stop) of the keys any query row of a sample sees, as the
    kernel finds it."""
    start = lp if window < 0 else max(lp, lp + length - sq - window)
    return max(0, start), min(lp + length, S)


MERGE_CASES = {  # sq, lengths, window, leftpad
    "ragged": (1, [200, 77], -1, None),
    "leftpad": (1, [150, 77], -1, [64, 30]),
    "window": (2, [200, 77], 48, None),
}


@functools.lru_cache(maxsize=None)
def _merge_case(name):
    """Inputs of a merge case and the JAX kernel's output (one JAX call per
    case, shared by the cluster sizes)."""
    sq, lengths, window, leftpad = MERGE_CASES[name]
    q, kc, vc = _inputs(sq, seed=20 + sq)
    kw = dict(window_size=(window, -1))
    if leftpad is not None:
        kw["leftpad_k"] = np.array(leftpad, np.int32)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(np.array(lengths, np.int32)),
                         softmax_scale=D ** -0.5,
                         **{k: (jnp.asarray(v) if k == "leftpad_k" else v)
                            for k, v in kw.items()})
    return q, kc, vc, kw, np.asarray(want)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_cluster_chunks_merge_to_the_whole(case, cluster):
    """Per-CTA partials over the chunks of the plan, merged with
    merge_attention_partials, equal flash_decode_ref (1e-6) and JAX's
    flash_decode (Pallas, interpret mode; 1e-5), fp32."""
    sq, lengths, window, leftpad = MERGE_CASES[case]
    q, kc, vc, kw, want = _merge_case(case)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    tl = torch.tensor(lengths, dtype=torch.int32)
    tkw = {"window_size": kw["window_size"]}
    if leftpad is not None:
        tkw["leftpad_k"] = torch.tensor(leftpad, dtype=torch.int32)
    s = decode_kernel.decode_scores_ref(tq, tk, tl, D ** -0.5, **tkw)
    cols = torch.arange(S)
    outs, ms, ls = [], [], []
    for rank in range(cluster):
        keep = torch.zeros(B, S, dtype=torch.bool)
        for bi in range(B):
            lp = leftpad[bi] if leftpad is not None else 0
            start, stop = _visible_range(lengths[bi], lp, sq, window, S)
            lo, hi = decode_kernel.cta_chunk(start, stop, 0, rank, cluster)
            keep[bi] = (cols >= lo) & (cols < hi)
        si = torch.where(keep[:, None, None], s, NEG_INF)
        m = si.amax(-1, keepdim=True)
        p = torch.exp(si - torch.clamp_min(m, 0.5 * NEG_INF))
        l = p.sum(-1, keepdim=True)
        outs.append(torch.einsum("bhrt,bhtd->bhrd", p, tv) /
                    torch.clamp_min(l, 1e-37))
        ms.append(m)
        ls.append(l)
    out, _, _ = combine.merge_attention_partials(
        torch.stack(outs), torch.stack(ms), torch.stack(ls), axis=0)
    got = decode_kernel._unpack_rows(out, B, sq, H, torch.float32)
    ref = decode_kernel.flash_decode_ref(tq, tk, tv, tl, D ** -0.5, **tkw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
