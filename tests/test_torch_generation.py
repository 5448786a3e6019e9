"""Port parity: greedy serving (prefill + KV-cache decode) against the JAX
package.

A tiny fp32 Llama (2 layers, GQA 4/2, head dim 64) is initialised by the
JAX package and carried into the port with `state_dict_from_jax`. Two
requests: a prompt within the packed-heads gate (JAX: Pallas kernel #5 for
the prefill) and one past it whose cache holds at least 1024 positions
(JAX: kernel #1 for the prefill and the decode kernel #4 for every step).
Greedy tokens are identical, the decode-step logits agree within 1e-4, and
the per-layer caches that the port writes in place equal the caches that
the JAX model returns.
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
from xhy_flash_attention_tpu.utils.generation import decode as jdecode
from xhy_flash_attention_tpu_torch import (
    GPTLMHeadModel,
    decode,
    llama_config_to_gpt_config,
    sample_logits,
    state_dict_from_jax,
)

TINY_LLAMA = types.SimpleNamespace(
    vocab_size=256, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10000.0, rms_norm_eps=1e-5)

REQUESTS = [(40, 46), (1030, 1034)]  # (prompt, max_length)


@pytest.fixture(scope="module")
def models():
    jmodel = JGPTLMHeadModel(jllama_config(TINY_LLAMA))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = llama_config_to_gpt_config(TINY_LLAMA)
    tmodel = GPTLMHeadModel(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, tmodel


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY_LLAMA.vocab_size, (2, n)).astype(np.int32)


@pytest.mark.parametrize("prompt,max_length", REQUESTS)
def test_greedy_decode_matches_jax(models, prompt, max_length):
    jmodel, params, tmodel = models
    ids = _prompt(prompt, seed=prompt)
    want, want_scores = jdecode(jmodel, params, jnp.asarray(ids), max_length,
                                return_scores=True)
    got, got_scores = decode(tmodel, torch.from_numpy(ids), max_length,
                             return_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("prompt,max_length", REQUESTS)
def test_cache_updates_match_jax(models, prompt, max_length):
    """Prefill, then two decode steps: the in-place caches of the port equal
    the caches the JAX model returns after every call."""
    jmodel, params, tmodel = models
    ids = _prompt(prompt + 2, seed=prompt + 1)
    jcaches = jmodel.allocate_kv_caches(2, max_length)
    tcaches = tmodel.allocate_kv_caches(2, max_length)
    steps = [(0, prompt), (prompt, prompt + 1), (prompt + 1, prompt + 2)]
    with torch.inference_mode():
        for start, end in steps:
            chunk = ids[:, start:end]
            jlogits, jcaches = jmodel.apply(
                params, jnp.asarray(chunk), kv_caches=jcaches,
                seqlen_offset=start)
            tlogits, same = tmodel(torch.from_numpy(chunk).long(),
                                   kv_caches=tcaches, seqlen_offset=start)
            assert same is tcaches
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       rtol=0, atol=1e-4)
            for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
                np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                           rtol=0, atol=1e-5)
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                           rtol=0, atol=1e-5)
    assert not tcaches[0][0][:, :, prompt + 2:].any()


def test_teacher_forcing_and_eos(models):
    _, _, tmodel = models
    teacher = torch.from_numpy(_prompt(16, seed=2)).long()
    seq, _ = decode(tmodel, teacher[:, :4], 16, teacher_outputs=teacher)
    assert torch.equal(seq, teacher)
    free, _ = decode(tmodel, teacher[:, :4], 12)
    eos = int(free[0, 5])
    stopped, _ = decode(tmodel, teacher[:, :4], 12, eos_token_id=eos)
    assert torch.equal(stopped[0, :6], free[0, :6])
    # after a row emits eos it keeps emitting eos
    assert bool((stopped[0, 6:][stopped[0, 6:] != 0] == eos).all())


def test_sample_logits_top_k_top_p():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0, 10.0]])
    assert int(sample_logits(logits)[0]) == 4
    gen = torch.Generator().manual_seed(0)
    top_k = {int(sample_logits(logits, gen, temperature=5.0, top_k=2)[0])
             for _ in range(32)}
    assert top_k <= {3, 4} and len(top_k) == 2
    # top_p=0.5 keeps only the dominant token
    top_p = {int(sample_logits(logits, gen, temperature=1.0, top_k=0,
                               top_p=0.5)[0]) for _ in range(16)}
    assert top_p == {4}
