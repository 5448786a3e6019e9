"""Port parity: Llama-family logits against Hugging Face ``transformers``
and the JAX package, on the tiny random configs of
tests/models/test_llama.py (GQA and MHA head counts, two rope bases, tied
embeddings, and Mistral's sliding window, which must bind: seqlen 48 past a
window of 16).

An HF model built locally from a config object (nothing downloaded) gives
its state_dict to ``remap_state_dict_hf_llama`` of the port and of the JAX
package; the same token ids go through all three in fp32 on the CPU (the
JAX package's Pallas kernels in interpret mode, the port's plain
versions). Tolerances: the port against HF 2e-3 absolute on the logits
(tests/models/test_llama.py's bound), against the JAX model 1e-4
(tests/test_torch_model.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.llama import (
    llama_config_to_gpt_config as jllama_config,
    remap_state_dict_hf_llama as jremap,
)
from xhy_flash_attention_tpu_torch import (
    GPTLMHeadModel,
    llama_config_to_gpt_config,
    remap_state_dict_hf_llama,
)

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(hf_model, hf_cfg, seqlen=48):
    sd = hf_model.state_dict()
    ids = np.random.default_rng(0).integers(0, hf_cfg.vocab_size, (2, seqlen))
    with torch.no_grad():
        ref = hf_model(torch.tensor(ids)).logits.numpy()
    cfg = llama_config_to_gpt_config(hf_cfg)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(remap_state_dict_hf_llama(sd, cfg))
    with torch.inference_mode():
        got, _ = model(torch.tensor(ids))
    got = got.numpy()[..., : hf_cfg.vocab_size]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    jcfg = jllama_config(hf_cfg)
    jparams = jremap({k: v.numpy() for k, v in sd.items()}, jcfg)
    want, _ = JGPTLMHeadModel(jcfg).apply(jparams, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want)[..., : hf_cfg.vocab_size],
                               rtol=0, atol=1e-4)
    return cfg


def _llama(**kw):
    return transformers.LlamaConfig(
        vocab_size=173, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        attention_dropout=0.0, **kw)


@pytest.mark.parametrize("rope_theta", [10000.0, 500000.0])
@pytest.mark.parametrize("num_kv_heads", [2, 4])
def test_llama_logits_match_hf_and_jax(num_kv_heads, rope_theta):
    """GQA (kv 2) and MHA (kv 4) x Llama-2 / Llama-3 rope bases."""
    hf_cfg = _llama(num_key_value_heads=num_kv_heads, rope_theta=rope_theta,
                    tie_word_embeddings=False)
    torch.manual_seed(0)
    _compare(transformers.LlamaForCausalLM(hf_cfg).eval(), hf_cfg)


def test_llama_tied_embeddings():
    hf_cfg = _llama(num_key_value_heads=2, tie_word_embeddings=True)
    torch.manual_seed(1)
    cfg = _compare(transformers.LlamaForCausalLM(hf_cfg).eval(), hf_cfg)
    assert cfg.tie_word_embeddings


def test_mistral_sliding_window_logits_match_hf_and_jax():
    """Mistral: the Llama remap with sliding_window 16 -> window_size (15,
    0); at seqlen 48 the window binds (the logits differ from the same
    weights without it)."""
    hf_cfg = transformers.MistralConfig(
        vocab_size=173, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=16, attention_dropout=0.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.MistralForCausalLM(hf_cfg).eval()
    cfg = _compare(hf_model, hf_cfg)
    assert cfg.window_size == (15, 0)
    import dataclasses
    wide = GPTLMHeadModel(dataclasses.replace(cfg, window_size=(-1, -1)),
                          device="cpu")
    wide.load_state_dict(remap_state_dict_hf_llama(hf_model.state_dict(), cfg))
    ids = torch.arange(48)[None] % hf_cfg.vocab_size
    with torch.inference_mode():
        assert not torch.allclose(wide(ids)[0][:, -1],
                                  hf_model(ids).logits[:, -1], atol=1e-2)
