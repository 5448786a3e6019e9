"""Port parity: the model and its plain-tensor layers against the JAX package.

The JAX package initialises a tiny model; `state_dict_from_jax` carries its
parameters into the port, and the same numpy token ids go through both
(JAX: Pallas kernels in interpret mode on the CPU; port: plain versions on
CPU tensors). fp32 logits agree within 1e-4. Rotary and the gated
activations are checked on their own at 1e-6, and the port's entry points
are checked to build on the card unless told otherwise.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.layers import rotary as jrot
from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.llama import (
    llama_config_to_gpt_config as jllama_config,
)
from xhy_flash_attention_tpu.ops import activations as jact
from xhy_flash_attention_tpu_torch import (
    GPTConfig,
    GPTLMHeadModel,
    llama_config_to_gpt_config,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.layers import rotary as trot
from xhy_flash_attention_tpu_torch.ops import activations as tact

TINY_LLAMA = types.SimpleNamespace(
    vocab_size=256, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=500000.0, rms_norm_eps=1e-5)

# GPT-2 style: LayerNorm, learned positions, tied head, biases, GELU MLP,
# h == hk and no rotary (attention straight on the packed Wqkv output)
TINY_GPT2 = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
    activation_function="gelu_approx", tie_word_embeddings=True)


def _port_model(jax_cfg, port_cfg, ids, seed=0):
    jmodel = JGPTLMHeadModel(jax_cfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = GPTLMHeadModel(port_cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, port_cfg))
    return jmodel, params, tmodel


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("seqlen", [40, 1030])
def test_llama_prefill_logits_match_jax(seqlen):
    """A prompt within the packed-heads gate and one past it (the flash
    attention kernel), fp32, 2 layers, GQA 4/2, head dim 64."""
    ids = _ids(TINY_LLAMA.vocab_size, (2, seqlen))
    jmodel, params, tmodel = _port_model(
        jllama_config(TINY_LLAMA), llama_config_to_gpt_config(TINY_LLAMA), ids)
    want, _ = jmodel.apply(params, jnp.asarray(ids))
    with torch.inference_mode():
        got, _ = tmodel(torch.from_numpy(ids).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_gpt2_style_logits_match_jax():
    ids = _ids(TINY_GPT2["vocab_size"], (2, 48), seed=1)
    jmodel, params, tmodel = _port_model(
        JGPTConfig(**TINY_GPT2), GPTConfig(**TINY_GPT2), ids, seed=1)
    assert "wte" in params["params"]
    want, _ = jmodel.apply(params, jnp.asarray(ids))
    with torch.inference_mode():
        got, _ = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_state_dict_from_jax_transposes_dense_kernels():
    cfg = llama_config_to_gpt_config(TINY_LLAMA)
    ids = _ids(TINY_LLAMA.vocab_size, (1, 8))
    _, params, tmodel = _port_model(jllama_config(TINY_LLAMA), cfg, ids)
    sd = state_dict_from_jax(params, cfg)
    assert set(sd) == set(tmodel.state_dict())
    kernel = params["params"]["transformer"]["layers_0"]["mixer"]["Wqkv"]["kernel"]
    wqkv = sd["transformer.layers.0.mixer.Wqkv.weight"]
    assert kernel.shape == (256, (4 + 2 * 2) * 64)
    assert tuple(wqkv.shape) == kernel.shape[::-1]
    np.testing.assert_array_equal(wqkv.numpy(), kernel.T)
    # the same tree without its top-level "params" key
    assert set(state_dict_from_jax(params["params"], cfg)) == set(sd)


def test_llama_config_matches_jax():
    got = llama_config_to_gpt_config(TINY_LLAMA)
    want = jllama_config(TINY_LLAMA)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "num_attention_heads_kv",
                  "intermediate_size", "max_position_embeddings",
                  "activation_function", "rms_norm", "layer_norm_epsilon",
                  "rotary_emb_fraction", "rotary_emb_base", "window_size",
                  "tie_word_embeddings", "qkv_proj_bias", "residual_in_fp32"):
        assert getattr(got, field) == getattr(want, field), field
    mistral = types.SimpleNamespace(**vars(TINY_LLAMA), sliding_window=32)
    assert llama_config_to_gpt_config(mistral).window_size == (31, 0)


@pytest.mark.parametrize("rotary_dim", [64, 32])
@pytest.mark.parametrize("interleaved", [False, True])
def test_rotary_matches_jax(interleaved, rotary_dim):
    rng = np.random.default_rng(rotary_dim)
    x = rng.standard_normal((2, 12, 4, 64)).astype(np.float32)
    jcos, jsin, _, _ = jrot.RotaryEmbedding(
        rotary_dim, base=500000.0).cos_sin(12, offset=7)
    cos, sin = trot.RotaryEmbedding(rotary_dim, base=500000.0).cos_sin(
        12, offset=7)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=1e-6)
    want = jrot.apply_rotary_emb(jnp.asarray(x), jcos, jsin, interleaved)
    got = trot.apply_rotary_emb(torch.from_numpy(x), cos, sin, interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["swiglu", "geglu"])
def test_gated_activations_match_jax(name):
    rng = np.random.default_rng(5)
    gate, up = (rng.standard_normal((4, 96)).astype(np.float32)
                for _ in range(2))
    want = getattr(jact, name)(jnp.asarray(gate), jnp.asarray(up))
    got = getattr(tact, name)(torch.from_numpy(gate), torch.from_numpy(up))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cuda_model_needs_bfloat16():
    # raised before any weight is allocated, so it runs without a card
    cfg = llama_config_to_gpt_config(TINY_LLAMA)  # float32
    with pytest.raises(NotImplementedError, match="bfloat16"):
        GPTLMHeadModel(cfg)
    with pytest.raises(NotImplementedError, match="Next slices of the port"):
        GPTLMHeadModel(cfg, device="cuda:0")


def test_entry_points_default_to_cuda():
    from xhy_flash_attention_tpu_torch.modules.mha import MHA

    for cls in (GPTLMHeadModel, MHA):
        default = inspect.signature(cls.__init__).parameters["device"].default
        assert default == "cuda", cls
