"""Port parity: decode attention against the JAX package.

The same numpy inputs go through JAX `flash_decode` (Pallas kernel in
interpret mode on the CPU) and the port's `flash_decode` / `decode_attention`
(the plain math on CPU tensors), with ragged per-sample lengths, one or two
new tokens, GQA, sliding window and softcap. fp32 agrees within 1e-5.
"""

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
from xhy_flash_attention_tpu_torch.ops.decode import decode_attention
from xhy_flash_attention_tpu_torch.ops.flash_attention import decode_kernel

B, H, HK, D, S = 2, 4, 2, 64, 256
LENGTHS = np.array([200, 77], np.int32)


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


@pytest.mark.parametrize("kw", [dict(kv_batch_idx=torch.tensor([1, 0])),
                                dict(leftpad_k=torch.tensor([0, 3]))])
def test_serving_slice_options_raise(kw):
    q, kc, vc = _inputs(1, seed=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                         torch.from_numpy(vc), torch.from_numpy(LENGTHS),
                         0.125, **kw)


def test_quantized_cache_raises():
    q, kc, vc = _inputs(1, seed=5)
    with pytest.raises(NotImplementedError, match="quantized"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(kc).to(torch.int8),
                         torch.from_numpy(vc).to(torch.int8),
                         torch.from_numpy(LENGTHS), 0.125)
