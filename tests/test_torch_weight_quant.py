"""Port parity: weight-only int8 / int4 quantization.

The same numpy inputs go through the JAX package and the port (plain
tensors on the CPU, fp32); the JAX model is built, quantized and applied
once per weight dtype and shared by the checks.

  * `quantize_weight`: int8 and int4 values and scales bit for bit (a zero
    column on the 1e-8 floor, values on rounding ties); `pack_int4` /
    `unpack_int4` round trip, two values a byte;
  * `weight_only_quant_matmul` against the JAX package's (1e-5 of the
    largest entry: fp32 sums in another order);
  * `tests/test_weight_quant_model.py`'s tiny model: the port's
    `quantize_gpt_params` of the float state dict equals
    `state_dict_from_jax` of the JAX package's quantized tree bit for bit;
    the quantized port model's logits within 1e-4 of the JAX quantized
    model's, and within that test's bounds of the float logits (int8 0.05,
    int4 0.35 of the largest float logit; int8 top-1 agreement above
    0.95); int4 weights take half of int8's bytes;
  * a cached decode with int8 KV caches: the prefill against the JAX
    quantized model (1e-4), the decode step within the int8 bound;
  * a Hugging Face Llama state dict through `remap_state_dict_hf_llama`
    then `quantize_gpt_params` serves through `decode` (int8 and int4),
    its logits within the int8 / int4 bounds of the float model's.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.gpt import \
    quantize_gpt_params as jquantize_gpt_params
from xhy_flash_attention_tpu.ops import quant as jquant
from xhy_flash_attention_tpu_torch import (GPTConfig, GPTLMHeadModel, decode,
                                           llama_config_to_gpt_config,
                                           quantize_gpt_params,
                                           remap_state_dict_hf_llama,
                                           state_dict_from_jax)
from xhy_flash_attention_tpu_torch.modules.linear import QuantDense
from xhy_flash_attention_tpu_torch.ops import quant as tquant

TINY = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_attention_heads_kv=2, intermediate_size=128,
    max_position_embeddings=0, rotary_emb_fraction=1.0, rms_norm=True,
    activation_function="swiglu", tie_word_embeddings=False,
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False)
JDTYPE = {"int8": jnp.int8, "int4": jnp.int4}
TDTYPE = {"int8": torch.int8, "int4": "int4"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    w[:, 3] = 0.0  # a zero column: its scale is the 1e-8 floor
    w[:, 5] = np.arange(48) - 23.5  # ties: k + 0.5 units of the scale
    return w


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_quantize_weight_bit_exact(wq):
    w = _weights()
    got, scale = tquant.quantize_weight(torch.from_numpy(w), TDTYPE[wq])
    want, wscale = jquant.quantize_weight(jnp.asarray(w), JDTYPE[wq])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int8))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(wscale).view(np.uint32))
    packed = tquant.pack_int4(got.t())
    assert packed.dtype == torch.uint8 and packed.shape == (40, 24)
    if wq == "int4":
        assert torch.equal(tquant.unpack_int4(packed), got.t())


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_weight_only_quant_matmul_matches_jax(wq):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    wq_t, scale = tquant.quantize_weight(torch.from_numpy(_weights()),
                                         TDTYPE[wq])
    wq_j, jscale = jquant.quantize_weight(jnp.asarray(_weights()),
                                          JDTYPE[wq])
    got = tquant.weight_only_quant_matmul(torch.from_numpy(x), wq_t, scale,
                                          torch.from_numpy(bias))
    want = np.asarray(jquant.weight_only_quant_matmul(
        jnp.asarray(x), wq_j, jscale, jnp.asarray(bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_float():
    """The JAX model's float parameters, the ids, and the float logits of
    the port's model on them (its parity with the JAX model:
    tests/test_torch_model.py)."""
    ids = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(np.int32)
    model = JGPTLMHeadModel(JGPTConfig(**TINY, dtype=jnp.float32))
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.asarray(ids)))
    cfg = GPTConfig(**TINY)
    tmodel = GPTLMHeadModel(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    with torch.inference_mode():
        logits, _ = tmodel(torch.from_numpy(ids).long())
    return params, ids, logits.numpy()


@functools.lru_cache(maxsize=None)
def _jax_quant(wq):
    params, ids, _ = _jax_float()
    cfg = JGPTConfig(**TINY, weight_quant=wq, dtype=jnp.float32)
    params_q = jquantize_gpt_params(params, cfg)
    logits, _ = JGPTLMHeadModel(cfg).apply(params_q, jnp.asarray(ids))
    return jax.device_get(params_q), np.asarray(logits)


def _port_quant(wq):
    params, _, _ = _jax_float()
    cfg_f, cfg_q = GPTConfig(**TINY), GPTConfig(**TINY, weight_quant=wq)
    sd = quantize_gpt_params(state_dict_from_jax(params, cfg_f), cfg_q)
    model = GPTLMHeadModel(cfg_q, device="cpu")
    model.load_state_dict(sd)
    return model, sd


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_quantized_model_matches_jax(wq):
    _, ids, logits_f = _jax_float()
    params_q, logits_jq = _jax_quant(wq)
    model, sd = _port_quant(wq)
    from_jax = state_dict_from_jax(params_q, model.config)
    assert set(from_jax) == set(sd)
    for name, t in sd.items():
        assert torch.equal(t, from_jax[name]), name
    assert isinstance(model.lm_head, QuantDense)
    assert isinstance(model.transformer.layers[0].mixer.Wqkv, QuantDense)
    with torch.inference_mode():
        logits_q, _ = model(torch.from_numpy(ids).long())
    logits_q = logits_q.numpy()
    np.testing.assert_allclose(logits_q, logits_jq, rtol=0, atol=1e-4)
    err = np.abs(logits_q - logits_f).max()
    scale = np.abs(logits_f).max()
    assert err < (0.05 if wq == "int8" else 0.35) * scale, (err, scale)
    if wq == "int8":
        agree = (logits_q.argmax(-1) == logits_f.argmax(-1)).mean()
        assert agree > 0.95, agree


def test_int4_weights_take_half_the_bytes():
    nbytes = {}
    for wq in ("int8", "int4"):
        model = GPTLMHeadModel(GPTConfig(**TINY, weight_quant=wq),
                               device="cpu")
        nbytes[wq] = sum(m.weight_q.numel() * m.weight_q.element_size()
                         for m in model.modules()
                         if isinstance(m, QuantDense))
    assert 2 * nbytes["int4"] == nbytes["int8"] > 0


def test_weight_quant_cached_decode():
    """The JAX test's int8-weight model with int8 KV caches: a prefill of 9
    tokens, then one decode step of the 10th. The prefill equals the JAX
    quantized model's logits at those positions (1e-4); the decode step,
    which reads the int8 cache, stays within the int8 bound (0.05 of the
    largest logit) of the JAX model's uncached logit at position 10."""
    _, ids, _ = _jax_float()
    _, logits_jq = _jax_quant("int8")
    model, _ = _port_quant("int8")
    prompt = torch.from_numpy(ids[:1, :9]).long()
    with torch.inference_mode():
        caches = model.allocate_kv_caches(1, 64, dtype=torch.int8)
        logits, caches = model(prompt, kv_caches=caches, seqlen_offset=0)
        logits2, _ = model(torch.from_numpy(ids[:1, 9:10]).long(),
                           kv_caches=caches, seqlen_offset=9)
    assert torch.isfinite(logits2).all()
    np.testing.assert_allclose(logits.numpy(), logits_jq[:1, :9], rtol=0,
                               atol=1e-4)
    scale = np.abs(logits_jq[0, 9]).max()
    assert np.abs(logits2[0, 0].numpy() - logits_jq[0, 9]).max() < \
        0.05 * scale


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_hf_llama_remap_then_quantize_serves(wq):
    hf = types.SimpleNamespace(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=500000.0, rms_norm_eps=1e-5)
    cfg = llama_config_to_gpt_config(hf)
    rng = np.random.default_rng(2)
    d, hk = 16, 2
    shapes = {"model.embed_tokens.weight": (128, 64), "model.norm.weight":
              (64,), "lm_head.weight": (128, 64)}
    for i in range(2):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (64,),
            pre + "post_attention_layernorm.weight": (64,),
            pre + "self_attn.q_proj.weight": (64, 64),
            pre + "self_attn.k_proj.weight": (hk * d, 64),
            pre + "self_attn.v_proj.weight": (hk * d, 64),
            pre + "self_attn.o_proj.weight": (64, 64),
            pre + "mlp.gate_proj.weight": (128, 64),
            pre + "mlp.up_proj.weight": (128, 64),
            pre + "mlp.down_proj.weight": (64, 128)})
    sd_hf = {k: (1.0 + 0.1 * rng.standard_normal(v) if len(v) == 1 else
                 0.05 * rng.standard_normal(v)).astype(np.float32)
             for k, v in shapes.items()}
    sd = remap_state_dict_hf_llama(sd_hf, cfg)
    model_f = GPTLMHeadModel(cfg, device="cpu")
    model_f.load_state_dict(sd)
    cfg_q = dataclasses.replace(cfg, weight_quant=wq)
    model_q = GPTLMHeadModel(cfg_q, device="cpu")
    model_q.load_state_dict(quantize_gpt_params(sd, cfg_q))
    ids = torch.from_numpy(rng.integers(0, 128, (2, 12)))
    with torch.inference_mode():
        lf, _ = model_f(ids)
        lq, _ = model_q(ids)
    err = (lq - lf).abs().max().item()
    assert err < (0.05 if wq == "int8" else 0.35) * lf.abs().max().item()
    seq, scores = decode(model_q, ids, 20, return_scores=True)
    assert seq.shape == (2, 20) and torch.equal(seq[:, :12], ids)
    assert torch.isfinite(scores).all()
