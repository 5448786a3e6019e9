"""Port parity: block-sparse attention against the JAX package.

The same numpy inputs (fp32) and output cotangents go through ``jax.vjp`` of
the JAX package's ``blocksparse_attention`` (Pallas kernels in interpret
mode on the CPU) and ``torch.autograd.grad`` of the port's (the plain
versions with the dense mask on CPU tensors): causal and full, one block
mask for all heads and one per head, with GQA (h 4 over hk 2), at
granularity 128, and with dropout (p 0.1, a seed: the same keep mask in
both packages); and the packed ``flash_blocksparse_attn_func``. Tolerances:
out and dq/dk/dv within 5e-5 of the largest entry (fp32 on both sides, sums
in another order). ``blockmask_to_dense`` agrees bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import blocksparse as jbs
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    blockmask_to_dense,
    blocksparse_attention,
    flash_blocksparse_attn_func,
)

B, H, HK, D, S, G = 2, 4, 2, 64, 256, 128
CASES = [(causal, hm) for causal in (False, True) for hm in (1, H)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case):
    causal, hm = case
    rng = np.random.default_rng(10 * hm + int(causal))
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, HK, S, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    n = S // G
    bm = rng.integers(0, 2, (1, hm, n, n)).astype(np.int32)
    # one block row fully off: its rows see nothing (out 0)
    bm[0, 0, 0] = 0
    return (q, k, v), do, bm


DROPOUT = dict(dropout_p=0.1, dropout_seed=3)


@functools.lru_cache(maxsize=None)
def _jax_run(case, dropout=False):
    causal = case[0]
    arrays, do, bm = _inputs(case)
    fn = lambda q, k, v: jbs.blocksparse_attention(  # noqa: E731
        q, k, v, jnp.asarray(bm), block_size=G, causal=causal,
        **(DROPOUT if dropout else {}))
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_run(case, dropout=False):
    causal = case[0]
    arrays, do, bm = _inputs(case)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = blocksparse_attention(*ins, torch.from_numpy(bm), block_size=G,
                                causal=causal, **(DROPOUT if dropout else {}))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _case_id(case):
    return f"{'causal' if case[0] else 'full'}-hm{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_blocksparse_forward_matches_jax(case):
    out, _ = _torch_run(case)
    want, _ = _jax_run(case)
    _close(out, want, 5e-5)
    assert not np.abs(out[:, 0, :G]).any()  # the block row that is off


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_blocksparse_grads_match_jax(case):
    _, grads = _torch_run(case)
    _, want = _jax_run(case)
    for g, w in zip(grads, want):
        _close(g, w, 5e-5)


def test_packed_wrapper_matches_jax():
    """qkv (b, s, 3, h, d) with a 2-D mask, causal."""
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    bm = np.array([[1, 0], [1, 1]], np.int32)
    want = jbs.flash_blocksparse_attn_func(jnp.asarray(qkv), jnp.asarray(bm),
                                           causal=True, block_size=G)
    got = flash_blocksparse_attn_func(torch.from_numpy(qkv),
                                      torch.from_numpy(bm), causal=True,
                                      block_size=G)
    _close(got.numpy(), np.asarray(want), 5e-5)


def test_blockmask_to_dense_matches_jax():
    rng = np.random.default_rng(8)
    bm = rng.integers(0, 2, (2, 3, 3, 2)).astype(np.int32)
    for bs in (128, (128, 256)):
        np.testing.assert_array_equal(
            blockmask_to_dense(torch.from_numpy(bm), 300, 400, bs).numpy(),
            np.asarray(jbs.blockmask_to_dense(jnp.asarray(bm), 300, 400, bs)))


def test_blocksparse_refusals():
    """Granularities that are not multiples of 128 and a mask of the wrong
    shape raise; dropout, which once raised here, runs as in the JAX
    package: out and dq/dk/dv with the same keep mask (causal, a mask per
    head)."""
    q = torch.zeros(1, 2, 256, D)
    bm = torch.ones(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        blocksparse_attention(q, q, q, bm, block_size=64)
    with pytest.raises(ValueError):
        blocksparse_attention(q, q, q, torch.ones(3, 2), block_size=128)
    out, grads = _torch_run(CASES[-1], dropout=True)
    want, want_grads = _jax_run(CASES[-1], dropout=True)
    _close(out, want, 5e-5)
    for g, w in zip(grads, want_grads):
        _close(g, w, 5e-5)
    assert not np.allclose(out, _jax_run(CASES[-1])[0], atol=1e-3)
