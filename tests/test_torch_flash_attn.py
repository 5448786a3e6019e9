"""Port parity: prefill attention against the JAX package.

The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode on the CPU) and the port (plain versions on CPU tensors):
  * flash_attention / flash_attn_func, causal and full, GQA, softcap, LSE:
    fp32 within 2e-5 of JAX and of the fp32 `attention_ref`; bf16 by the
    repo's contract (error against the fp32 reference at most twice the
    error of the bf16 reorder-ops baseline);
  * packed_heads_attention and packed_qkv_attention (the projection-layout
    kernel's entries) within 2e-5 of JAX in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import fused_heads as jfh
from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    attention_ref,
    flash_attention,
    flash_attn_func,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as tfh
from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
    TRAINING_NOT_PORTED,
)

B, H, HK, D = 2, 4, 2, 64


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (113, 203)])
def test_flash_attention_fp32_matches_jax(sq, sk, causal, softcap):
    rng = np.random.default_rng(sq + sk)
    q, k, v = _randn(rng, (B, H, sq, D)), _randn(rng, (B, HK, sk, D)), \
        _randn(rng, (B, HK, sk, D))
    want, want_lse = jflash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap, return_lse=True)
    got, got_lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softcap=softcap, return_lse=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)
    # rows that see no key carry lse = +inf in both packages
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), rtol=0, atol=2e-5)
    ref, _ = attention_ref(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=causal, softcap=softcap)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(ref), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (113, 203)])
def test_flash_attn_func_bf16_contract(sq, sk, causal):
    rng = np.random.default_rng(7 * sq + sk)
    q, k, v = (_bf16_round(_randn(rng, s)) for s in
               ((B, sq, H, D), (B, sk, HK, D), (B, sk, HK, D)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attn_func(tq, tk, tv, causal=causal)
    want = jflash_attention(
        *(jnp.asarray(a, jnp.bfloat16).swapaxes(1, 2) for a in (q, k, v)),
        causal=causal).swapaxes(1, 2)
    ref, _ = attention_ref(tq, tk, tv, causal=causal, upcast=True)
    lp, _ = attention_ref(tq, tk, tv, causal=causal, upcast=False,
                          reorder_ops=True)
    err_lp = np.abs(_np(lp) - _np(ref)).max()
    assert np.abs(_np(got) - _np(ref)).max() <= 2 * err_lp + 1e-4
    assert np.abs(_np(want) - _np(ref)).max() <= 2 * err_lp + 1e-4


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_heads_attention_matches_jax(causal, softcap):
    s = 128
    rng = np.random.default_rng(11)
    q, k, v = _randn(rng, (B, s, H, D)), _randn(rng, (B, s, HK, D)), \
        _randn(rng, (B, s, HK, D))
    assert tfh.packed_heads_supported(
        q.shape, k.shape, causal=causal, window_size=(-1, -1), softcap=softcap)
    want = jfh.packed_heads_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap)
    got = tfh.packed_heads_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softcap=softcap)
    assert got.shape == (B, s, H, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2)])
def test_packed_qkv_attention_matches_jax(h, hk):
    s = 96
    rng = np.random.default_rng(h + hk)
    qkv = _randn(rng, (B, s, (h + 2 * hk) * D))
    want = jfh.packed_qkv_attention(
        jnp.asarray(qkv), num_heads=h, num_heads_kv=hk, head_dim=D,
        causal=True)
    got = tfh.packed_qkv_attention(
        torch.from_numpy(qkv), num_heads=h, num_heads_kv=hk, head_dim=D,
        causal=True)
    assert got.shape == (B, s, h * D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,ok", [
    (((2, 1024, 4, 64), (2, 1024, 2, 64)), True),
    (((2, 1025, 4, 64), (2, 1025, 2, 64)), False),
    (((2, 64, 4, 64), (2, 64, 1, 64)), False),   # hk * d not a multiple of 128
    (((2, 64, 4, 64), (2, 80, 2, 64)), False),   # sq != sk
])
def test_packed_gate_matches_jax(shape, ok):
    qs, ks = shape
    kw = dict(causal=True, window_size=(-1, -1), softcap=0.0)
    assert tfh.packed_heads_supported(qs, ks, **kw) is ok
    assert jfh.packed_heads_supported(qs, ks, **kw) is ok


def test_attention_inputs_needing_grad_raise():
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    k = torch.randn(1, 2, 8, 64)
    with pytest.raises(RuntimeError, match="Training"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(RuntimeError, match="Training"):
        tfh.packed_heads_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   k.transpose(1, 2))
    assert "ROADMAP.md" in TRAINING_NOT_PORTED


@pytest.mark.parametrize("kw", [dict(window_size=(16, 0)),
                                dict(dropout_p=0.1, dropout_seed=0)])
def test_unported_flags_raise(kw):
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, q, q, causal=True, **kw)
