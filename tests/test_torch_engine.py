"""Port parity: the continuous-batching InferenceEngine against the JAX
package's.

A tiny Llama-shaped GPT (2 layers, hidden 64, 4/2 heads of 16, rotary) is
initialised by the JAX package and carried into the port with
`state_dict_from_jax`. Two JAX engine runs (module-scoped; the page table
and lengths pushed as copies, see `_JEngine`): fp32 pages and INT8 pages,
whole-prompt prefill, four requests on two slots so that two of
them wait and enter mid-run. The port's engine must give the same greedy
tokens, except after a step whose top-2 logit margin (of the port's dense
fp32 decode) lies below TIE = 1e-4, where fp32 rounding noise between the
two frameworks may pick either token:
  * fp32 pages, whole-prompt prefill and chunked prefill (prompts of 20
    and 30 tokens in chunks of 16; the port counts an empty slot's first
    chunk, see inference/engine.py, so chunked and whole prefill agree);
  * INT8 pages;
  * prompt-lookup speculation (against the port's plain engine);
  * `decode(cache_dtype=int8)` (the dense quantized cache) against the INT8
    engine.
Layers share one lengths tensor per call; a test checks that the appends of
layer 0 leave it untouched for layer 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.inference import InferenceEngine as JEngine
from xhy_flash_attention_tpu.inference import Request as JRequest
from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu_torch import (
    GPTConfig,
    GPTLMHeadModel,
    decode,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.inference import (
    InferenceEngine,
    PagedKVCache,
    Request,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JEngine(JEngine):
    """The JAX engine with its host page table and lengths pushed as
    copies. On the CPU, jnp.asarray may alias a 64-byte-aligned numpy array
    instead of copying it, so the engine's later host-side updates of
    ``_lengths`` and ``_table`` can reach device values still in use, and
    its tokens then depend on where numpy placed those arrays."""

    def _sync_caches(self):
        table = jnp.asarray(self._table.copy())
        lengths = jnp.asarray(self._lengths.copy())
        self.caches = [dataclasses.replace(c, page_table=table,
                                           lengths=lengths)
                       for c in self.caches]


TIE = 1e-4
CONFIG = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_attention_heads_kv=2, intermediate_size=128,
    max_position_embeddings=0, rotary_emb_fraction=1.0, rms_norm=True,
    activation_function="swiglu", tie_word_embeddings=False,
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False)
ENGINE = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=24,
              page_size=32, max_batch=2, max_pages_per_seq=4)
# (prompt length, new tokens); one prefill bucket (32) keeps the JAX
# engine's compilations few
PROMPTS = [(5, 6), (20, 5), (9, 7), (30, 4)]


@pytest.fixture(scope="module")
def setup():
    jmodel = JGPTLMHeadModel(JGPTConfig(**CONFIG, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = GPTConfig(**CONFIG, dtype=torch.float32)
    tmodel = GPTLMHeadModel(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n, _ in PROMPTS]
    jax_tokens = {}
    for name, dt in (("fp32", jnp.float32), ("int8", jnp.int8)):
        eng = _JEngine(jmodel.apply, params, dtype=dt, **ENGINE)
        for i, (p, (_, n)) in enumerate(zip(prompts, PROMPTS)):
            eng.add_request(JRequest(rid=i, prompt=p, max_new_tokens=n))
        jax_tokens[name] = eng.run()
    margins = {}
    for i, (p, (_, n)) in enumerate(zip(prompts, PROMPTS)):
        _, scores = decode(tmodel, torch.from_numpy(p)[None].long(),
                           len(p) + n, return_scores=True)
        top2 = scores[0].topk(2, -1).values
        margins[i] = (top2[:, 0] - top2[:, 1]).tolist()
    return tmodel, prompts, jax_tokens, margins


def _run(tmodel, prompts, **kw):
    eng = InferenceEngine(tmodel, dtype=kw.pop("dtype", torch.float32),
                          **ENGINE, **kw)
    for i, (p, (_, n)) in enumerate(zip(prompts, PROMPTS)):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
    return eng.run(), eng


def _same_modulo_ties(got, want, margins):
    assert set(got) == set(want)
    for rid in want:
        assert len(got[rid]) == len(want[rid])
        for t, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                assert margins[rid][t] < TIE, (rid, t, margins[rid][t])
                break


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_engine_fp32_matches_jax(setup, prefill_chunk):
    tmodel, prompts, jax_tokens, margins = setup
    got, eng = _run(tmodel, prompts, prefill_chunk=prefill_chunk)
    _same_modulo_ties(got, jax_tokens["fp32"], margins)
    # two requests wait for a slot and enter mid-run
    assert eng.stats["decode"] > max(n for _, n in PROMPTS)
    assert (eng.stats["chunk"] > 0) == (prefill_chunk is not None)
    assert eng.free_pages and len(eng.free_pages) == ENGINE["num_pages"] - 1


def test_engine_int8_matches_jax(setup):
    tmodel, prompts, jax_tokens, margins = setup
    got, eng = _run(tmodel, prompts, dtype=torch.int8)
    assert eng.caches[0].kv_scales is not None
    _same_modulo_ties(got, jax_tokens["int8"], margins)


def test_speculative_and_quantized_dense_decode(setup):
    tmodel, prompts, jax_tokens, margins = setup
    spec, eng = _run(tmodel, prompts, speculate_len=3)
    assert eng.stats["verify"] > 0 and eng.stats["decode"] == 0
    _same_modulo_ties(spec, jax_tokens["fp32"], margins)
    int8, _ = _run(tmodel, prompts, dtype=torch.int8)
    dense = {}
    for i, (p, (_, n)) in enumerate(zip(prompts, PROMPTS)):
        seq, _ = decode(tmodel, torch.from_numpy(p)[None].long(), len(p) + n,
                        cache_dtype=torch.int8)
        dense[i] = seq[0, len(p):].tolist()
    _same_modulo_ties(dense, int8, margins)


def test_layers_share_lengths_untouched(setup):
    """One model call over two paged layers that share a lengths tensor:
    layer 0's append must not move layer 1's positions."""
    tmodel = setup[0]
    caches = [PagedKVCache.create(6, 2, 32, 16, 2, 2, torch.float32,
                                  device="cpu") for _ in range(2)]
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    caches = [dataclasses.replace(c, page_table=table, lengths=lengths)
              for c in caches]
    ids = torch.randint(0, 128, (2, 1), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        tmodel(ids, kv_caches=caches, seqlen_offset=lengths)
    assert lengths.tolist() == [3, 5]
    assert [c.lengths.tolist() for c in caches] == [[4, 6], [4, 6]]
    # every layer wrote its new row at the same position
    for c in caches:
        assert c.kv_pages[0, :, :, 3].abs().sum() > 0
        assert c.kv_pages[1].abs().sum() == 0


def test_engine_refuses_requests_past_the_page_table(setup):
    """A request that would write past ``max_pages_per_seq * page_size``
    positions raises ValueError (append_paged_kv, bit-exact with JAX, would
    clamp those rows onto the sequence's last page, over committed rows):
    at admission, and before a prefill chunk that would run a slot past its
    table. A request that fits exactly runs to the end."""
    tmodel = setup[0]
    cap = ENGINE["max_pages_per_seq"] * ENGINE["page_size"]
    prompt = (np.arange(100) % CONFIG["vocab_size"]).astype(np.int32)
    eng = InferenceEngine(tmodel, dtype=torch.float32, **ENGINE)
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        eng.add_request(Request(rid=0, prompt=prompt,
                                max_new_tokens=cap - len(prompt) + 1))
    eng.add_request(Request(rid=1, prompt=prompt,
                            max_new_tokens=cap - len(prompt)))
    assert len(eng.run()[1]) == cap - len(prompt)
    spec = InferenceEngine(tmodel, dtype=torch.float32, speculate_len=3,
                           **ENGINE)
    with pytest.raises(ValueError, match="speculate_len"):
        spec.add_request(Request(rid=2, prompt=prompt,
                                 max_new_tokens=cap - len(prompt)))
    chunk = 16
    chunked = InferenceEngine(tmodel, dtype=torch.float32,
                              prefill_chunk=chunk, **ENGINE)
    chunked.add_request(Request(rid=3, prompt=prompt[:10],
                                max_new_tokens=cap - 10))
    while chunked._lengths.max() + chunk <= cap:
        chunked.step()
    chunked.add_request(Request(rid=4, prompt=prompt[:2 * chunk],
                                max_new_tokens=4))
    with pytest.raises(ValueError, match="prefill chunk"):
        chunked.step()
