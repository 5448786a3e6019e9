"""Port parity: KV-cache quantization against the JAX package.

Per-token symmetric int8 and e4m3 quantization must agree bit for bit
(payload bytes and fp32 scales) for fp32 and bf16 inputs, zero rows and
tiny magnitudes included; dequantization agrees exactly. The model's int8
dense cache (`allocate_kv_caches(dtype=int8)`) has the JAX package's
layout, and a prefill plus decode steps through it write the payload and
scales that the JAX model writes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.llama import (
    llama_config_to_gpt_config as jllama_config,
)
from xhy_flash_attention_tpu.ops.quant import dequantize_kv as jdequantize_kv
from xhy_flash_attention_tpu.ops.quant import quantize_kv as jquantize_kv
from xhy_flash_attention_tpu_torch import (
    GPTLMHeadModel,
    llama_config_to_gpt_config,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.ops.quant import (
    QuantizedKV,
    dequantize_kv,
    quantize_kv,
)

DTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else x.numpy()
    return np.asarray(x).view(np.uint8)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 67, 64)) * np.exp(
        rng.uniform(-12.0, 4.0, (2, 3, 67, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: scale 1e-8
    x[0, 0, 1, :3] = [1e-10, -1e-9, 3e-10]  # tiny values: e4m3 subnormals
    return x


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantize_kv_is_bit_exact(jdt, tdt, bf16):
    x = _inputs(0)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    want = jquantize_kv(jx, jdt)
    got = quantize_kv(tx, tdt)
    assert got.values.dtype == tdt and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        dequantize_kv(got).numpy(), np.asarray(jdequantize_kv(want)))


def test_quantized_kv_container():
    q = quantize_kv(torch.randn(2, 2, 5, 8), torch.int8)
    assert isinstance(q, QuantizedKV)
    assert q.shape == (2, 2, 5, 8) and q.dtype == torch.int8
    assert q.scales.shape == (2, 2, 5, 1)
    c = q.clone()
    c.values.zero_()
    assert q.values.abs().sum() > 0
    with pytest.raises(TypeError):
        quantize_kv(torch.randn(2, 8), torch.float16)


TINY_LLAMA = types.SimpleNamespace(
    vocab_size=128, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10000.0, rms_norm_eps=1e-5)


def test_quantized_dense_cache_matches_jax():
    """Prefill and two decode steps into a quantized dense cache: the
    payload bytes equal JAX's except where fp32 rounding of the projections
    moves a value across a quantization step (at most one step on a few
    elements), scales agree within 1e-6 relative, logits within 1e-4."""
    jmodel = JGPTLMHeadModel(jllama_config(TINY_LLAMA))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    apply = jax.jit(jmodel.apply, static_argnames="seqlen_offset")
    cfg = llama_config_to_gpt_config(TINY_LLAMA)
    tmodel = GPTLMHeadModel(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    jdt, tdt = jnp.int8, torch.int8
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    jcaches = jmodel.allocate_kv_caches(2, 16, dtype=jdt)
    tcaches = tmodel.allocate_kv_caches(2, 16, dtype=tdt)
    assert isinstance(tcaches[0][0], QuantizedKV)
    assert tcaches[0][0].scales.shape == (2, 2, 16, 1)
    with torch.inference_mode():
        for start, end in ((0, 10), (10, 11), (11, 12)):
            jl, jcaches = apply(params, jnp.asarray(ids[:, start:end]),
                                kv_caches=jcaches, seqlen_offset=start)
            tl, tcaches = tmodel(torch.from_numpy(ids[:, start:end]).long(),
                                 kv_caches=tcaches, seqlen_offset=start)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=1e-4)
    for jc, tc in zip(jcaches, tcaches):
        for jkv, tkv in zip(jc, tc):
            a = tkv.values.float().numpy()
            b = np.asarray(jkv.values.astype(jnp.float32))
            assert np.abs(a - b).max() <= 1.0
            assert (a != b).mean() < 0.01
            np.testing.assert_allclose(tkv.scales.numpy(),
                                       np.asarray(jkv.scales), rtol=1e-6)
