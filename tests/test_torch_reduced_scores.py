"""Port parity: calc_reduced_attn_scores against the JAX package.

The same numpy q, k and LSE (fp32; the LSE of a causal forward, with some
rows set to +inf as a forward gives rows that see no key) go through the
JAX package's ``calc_reduced_attn_scores`` (its Pallas kernel in interpret
mode on the CPU) and the port's plain version: causal and full, GQA (h 4
over hk 2) and h == hk, sq == sk and sq != sk. Tolerance: 1e-5 of the
largest score (fp32 on both sides, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import reduced_scores as jrs
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    calc_reduced_attn_scores,
    flash_attention,
)

B, H, D = 2, 4, 64


@pytest.mark.parametrize("sq,sk", [(192, 192), (96, 160)])
@pytest.mark.parametrize("hk", [H, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_reduced_scores_match_jax(causal, hk, sq, sk):
    rng = np.random.default_rng(sq + sk + hk + int(causal))
    q = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, hk, sk, D)).astype(np.float32)
            for _ in range(2))
    _, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             return_lse=True)
    lse = lse.numpy().copy()
    lse[0, 1, :5] = np.inf
    got = calc_reduced_attn_scores(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(lse), causal=causal)
    want = np.asarray(jrs.calc_reduced_attn_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse), causal=causal))
    assert got.shape == (B, H, sk) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_reduced_scores_sum_to_rows():
    """With the LSE of full attention over the same keys, each row's
    probabilities sum to 1, so the reduced scores of a head sum to sq."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, 80, D))
                                .astype(np.float32)) for _ in range(3))
    _, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = calc_reduced_attn_scores(q, k, lse, causal=True)
    torch.testing.assert_close(got.sum(-1), torch.full((B, H), 80.0),
                               rtol=1e-5, atol=0)
