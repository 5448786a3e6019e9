"""Port parity: the static decode steps (utils/generation.py `DecodeStep`,
the engine's decode and verify steps), run uncaptured on the CPU.

On a CUDA device these steps are captured once as CUDA graphs and replayed
per token (tests/test_torch_gpu.py holds the graphs against the uncaptured
steps on the card). Here they run as they would be captured: the model over
fixed token, offset, page-table and lengths tensors updated in place.

A tiny Llama-shaped GPT (2 layers, hidden 64, 4/2 heads of 16, rotary) is
initialised by the JAX package and carried into the port with
`state_dict_from_jax`, in fp32:
  * (a) `decode()` against the JAX package's jitted `decode`, greedy and
    teacher-forced, dense and int8 caches: tokens equal, logits within
    1e-4 (the two frameworks round fp32 differently; the same tolerance as
    tests/test_torch_generation.py). One JAX call per cache kind: the
    teacher-forced runs feed the JAX run's tokens.
  * (b) `decode()` against the port's eager loop (a model call per token
    with an int offset, as `decode()` ran before its step was static):
    sequences and logits bit for bit, greedy and sampled.
  * (c) the engine against an engine that builds fresh device tensors at
    every model call (as it did before its steps were static): 12
    requests, tokens bit for bit; bf16 and int8 pages, with and without
    speculation, and chunked prefill.
  * (d) a step built once, its buffers changed in place: its next call
    equals a fresh eager call on the new values, bit for bit.
  * (e) one call of each static step (and of `fused_decode_step` with a
    dense, int8 or paged cache) reads nothing back to the host: no
    `aten._local_scalar_dense` or `aten.item` (`.item()`, `int()`), no
    `aten.is_nonzero` (`bool()`), `aten.equal` or `aten.nonzero` under a
    TorchDispatchMode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.utils.generation import decode as jdecode
from xhy_flash_attention_tpu_torch import (
    GPTConfig,
    GPTLMHeadModel,
    decode,
    sample_logits,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.inference import (
    InferenceEngine,
    PagedKVCache,
    Request,
    fused_decode_step,
)
from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
from xhy_flash_attention_tpu_torch.utils.generation import (
    DecodeStep,
    InferenceParams,
)

CONFIG = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_attention_heads_kv=2, intermediate_size=128,
    max_position_embeddings=0, rotary_emb_fraction=1.0, rms_norm=True,
    activation_function="swiglu", tie_word_embeddings=False,
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False)
B, PROMPT, MAX_LENGTH = 2, 12, 24
CACHES = {"dense": None, "int8": torch.int8}
JCACHES = {"dense": None, "int8": jnp.int8}
ENGINE = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=40,
              page_size=16, max_batch=4, max_pages_per_seq=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The steps are thousands of tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JGPTLMHeadModel(JGPTConfig(**CONFIG, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = GPTConfig(**CONFIG, dtype=torch.float32)
    tmodel = GPTLMHeadModel(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(0)
    return rng.integers(0, CONFIG["vocab_size"], (B, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(models, prompt):
    """One greedy JAX decode per cache kind: (sequences, scores)."""
    jmodel, params, _ = models
    runs = {}
    for kind, dt in JCACHES.items():
        seq, scores = jdecode(jmodel, params, jnp.asarray(prompt), MAX_LENGTH,
                              return_scores=True, cache_dtype=dt)
        runs[kind] = (np.asarray(seq), np.asarray(scores))
    return runs


@pytest.mark.parametrize("forced", [False, True], ids=["greedy", "teacher"])
@pytest.mark.parametrize("kind", list(CACHES))
def test_static_decode_matches_jax(models, prompt, jax_runs, kind, forced):
    tmodel = models[2]
    want_seq, want_scores = jax_runs[kind]
    teacher = torch.tensor(want_seq).long() if forced else None
    seq, scores = decode(tmodel, torch.from_numpy(prompt).long(), MAX_LENGTH,
                         teacher_outputs=teacher, return_scores=True,
                         cache_dtype=CACHES[kind])
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=0, atol=1e-4)


def _eager_decode(model, ids, max_length, cache_dtype, generator=None,
                  **sampling):
    """The decode loop with a model call per token at an int offset and a
    fresh token tensor per step."""
    b, n = ids.shape
    caches = model.allocate_kv_caches(b, max_length, dtype=cache_dtype)
    seq = torch.zeros(b, max_length, dtype=torch.int64)
    seq[:, :n] = ids
    scores = []
    with torch.inference_mode():
        logits, caches = model(ids, kv_caches=caches, seqlen_offset=0)
        last = logits[:, -1]
        for i in range(max_length - n):
            tok = sample_logits(last, generator, **sampling)
            seq[:, n + i] = tok
            scores.append(last.float())
            logits, caches = model(tok[:, None], kv_caches=caches,
                                   seqlen_offset=n + i)
            last = logits[:, 0]
    return seq, torch.stack(scores, 1)


SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=8)}


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("kind", list(CACHES))
def test_static_decode_matches_eager_loop(models, prompt, kind, sampling):
    tmodel = models[2]
    ids = torch.from_numpy(prompt).long()
    want = _eager_decode(tmodel, ids, MAX_LENGTH, CACHES[kind],
                         torch.Generator().manual_seed(5),
                         **SAMPLING[sampling])
    got = decode(tmodel, ids, MAX_LENGTH, cache_dtype=CACHES[kind],
                 generator=torch.Generator().manual_seed(5),
                 return_scores=True, **SAMPLING[sampling])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


class _FreshTensorsEngine(InferenceEngine):
    """The engine as it ran before its steps were static: device tensors
    made anew from the host arrays at every model call, and the layer
    caches replaced by those that the model returns."""

    def _sync_caches(self, active=None, ids=None):
        table = torch.from_numpy(self._table.copy())
        lengths = torch.from_numpy(self._lengths.copy())
        act = None if active is None else torch.from_numpy(active.copy())
        self.caches = [dataclasses.replace(c, page_table=table,
                                           lengths=lengths, active=act)
                       for c in self.caches]
        self._ids = torch.from_numpy(ids).long()

    def _forward(self, width):
        with torch.inference_mode():
            logits, self.caches = self.model(
                self._ids, kv_caches=self.caches,
                seqlen_offset=self.caches[0].lengths)
        return logits

    def _run(self, ids):
        self._sync_caches(ids=ids)
        return self._forward(ids.shape[1])


def _requests(seed=0, n=12):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, CONFIG["vocab_size"], int(rng.integers(3, 30))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 9)))
        for i in range(n)]


def _serve(cls, model, **kw):
    eng = cls(model, **ENGINE, **kw)
    for r in _requests():
        eng.add_request(r)
    return eng.run(), eng


ENGINE_CASES = {
    "bf16": dict(dtype=torch.bfloat16),
    "int8": dict(dtype=torch.int8),
    "bf16-speculate": dict(dtype=torch.bfloat16, speculate_len=3),
    "int8-speculate": dict(dtype=torch.int8, speculate_len=3),
    "bf16-chunked": dict(dtype=torch.bfloat16, prefill_chunk=16),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_static_engine_matches_fresh_tensors(models, case):
    tmodel = models[2]
    kw = ENGINE_CASES[case]
    got, eng = _serve(InferenceEngine, tmodel, **kw)
    want, ref = _serve(_FreshTensorsEngine, tmodel, **kw)
    assert got == want and len(got) == 12
    assert eng.stats == ref.stats
    step = "verify" if kw.get("speculate_len") else "decode"
    assert eng.stats[step] > 0 and set(eng._steps) == {
        1 + kw.get("speculate_len", 0)}
    assert (eng.stats["chunk"] > 0) == ("prefill_chunk" in kw)
    # the layer caches still share the engine's own device tensors
    assert all(c.lengths is eng._dev["lengths"]
               and c.page_table is eng._dev["table"] for c in eng.caches)


def _prefilled_step(tmodel, prompt, kind):
    step = DecodeStep(tmodel, B, MAX_LENGTH, CACHES[kind])
    with torch.inference_mode():
        tmodel(torch.from_numpy(prompt).long(), kv_caches=list(step.caches),
               seqlen_offset=0)
        step.offset.fill_(PROMPT)
        step.tokens.copy_(torch.tensor([[3], [7]]))
    return step


def _clone_caches(caches):
    return [tuple(t.clone() for t in pair) for pair in caches]


def _caches_equal(a, b):
    def flat(caches):
        for pair in caches:
            for t in pair:
                yield from ((t.values, t.scales) if hasattr(t, "scales")
                            else (t,))
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


@pytest.mark.parametrize("kind", list(CACHES))
def test_decode_step_reads_its_buffers_in_place(models, prompt, kind):
    tmodel = models[2]
    step = _prefilled_step(tmodel, prompt, kind)
    step()
    with torch.inference_mode():
        step.tokens.copy_(torch.tensor([[11], [2]]))
        step.offset.copy_(torch.tensor([PROMPT - 4, PROMPT + 3],
                                       dtype=torch.int32))
        ref_caches = _clone_caches(step.caches)
        want, _ = tmodel(step.tokens.clone(), kv_caches=ref_caches,
                         seqlen_offset=step.offset.clone())
    got = step()
    assert torch.equal(got, want[:, 0])
    assert _caches_equal(step.caches, ref_caches)
    assert step.offset.tolist() == [PROMPT - 3, PROMPT + 4]


def _engine_mid_run(tmodel, **kw):
    eng = InferenceEngine(tmodel, **ENGINE, **kw)
    for r in _requests(n=4):
        eng.add_request(r)
    eng.step()
    return eng


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_engine_step_reads_its_buffers_in_place(models, dtype):
    tmodel = models[2]
    eng = _engine_mid_run(tmodel, dtype=dtype)
    step = eng._step(1)
    table = torch.arange(16, dtype=torch.int32).reshape(4, 4).flip(0)
    lengths = torch.tensor([20, 0, 33, 7], dtype=torch.int32)
    ids = torch.tensor([[5], [6], [7], [8]])
    with torch.inference_mode():
        eng._dev["table"].copy_(table)
        eng._dev["lengths"].copy_(lengths)
        eng._dev["active"].copy_(lengths > 0)
        eng._dev[("ids", 1)].copy_(ids)
        ref = [dataclasses.replace(c.clone(), page_table=table.clone(),
                                   lengths=lengths.clone(), active=None)
               for c in eng.caches]
        want, ref = tmodel(ids, kv_caches=ref, seqlen_offset=lengths.clone())
    got = step()
    assert torch.equal(got, want)
    for c, r in zip(eng.caches, ref):
        assert torch.equal(c.kv_pages.view(torch.uint8),
                           r.kv_pages.view(torch.uint8))
        assert c.kv_scales is None or torch.equal(c.kv_scales, r.kv_scales)
    # the host advances the lengths: the step leaves them
    assert torch.equal(eng._dev["lengths"], lengths)


class _HostReads(TorchDispatchMode):
    """Records the ops that would read a device value back to the host."""

    # under inference mode `.item()` reaches the mode as aten.item, not
    # decomposed into _local_scalar_dense
    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.item.default,
             torch.ops.aten.is_nonzero.default,
             torch.ops.aten.equal.default,
             torch.ops.aten.nonzero.default}

    def __init__(self):
        super().__init__()
        self.seen, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func in self.READS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _fused_step(kind):
    """fused_decode_step on fixed tensors (b 2, 4/2 heads of 16, a cache of
    32 positions), dense, int8 or paged."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k, v = (torch.randn(2, 2, 1, 16, generator=g) for _ in range(2))
    inv = 1.0 / (10000.0 ** (torch.arange(0, 16, 2) / 16))
    lengths = torch.tensor([5, 17], dtype=torch.int32)
    if kind == "paged":
        cache = dataclasses.replace(
            PagedKVCache.create(4, 2, 16, 16, 2, 2, torch.float32,
                                device="cpu"),
            page_table=torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
            lengths=lengths)
        lengths = None
    else:
        cache = tuple(torch.randn(2, 2, 32, 16, generator=g)
                      for _ in range(2))
        if kind == "int8":
            cache = tuple(quantize_kv(c, torch.int8) for c in cache)
    return lambda: fused_decode_step(q, k, v, cache, lengths, inv,
                                     softmax_scale=0.25)[0]


STEPS = ["decode-dense", "decode-int8", "engine-bf16", "engine-int8",
         "verify-bf16", "verify-int8", "fused-dense", "fused-int8",
         "fused-paged"]


@pytest.mark.parametrize("which", STEPS)
def test_static_steps_read_nothing_on_the_host(models, prompt, which):
    tmodel = models[2]
    what, kind = which.split("-")
    if what == "decode":
        step = _prefilled_step(tmodel, prompt, kind)
    elif what == "fused":
        step = _fused_step(kind)
    else:
        spec = 3 if what == "verify" else 0
        eng = _engine_mid_run(
            tmodel, dtype={"bf16": torch.bfloat16, "int8": torch.int8}[kind],
            speculate_len=spec)
        step = eng._step(1 + spec)
    mode = _HostReads()
    with mode:
        step()
    assert mode.ops > 20 and mode.seen == []


def test_inference_params_as_the_jax_package_has_them():
    from xhy_flash_attention_tpu.utils import generation as jgen
    from xhy_flash_attention_tpu_torch.utils import generation as tgen
    assert "InferenceParams" in tgen.__all__
    fields = [(f.name, f.default) for f in dataclasses.fields(InferenceParams)]
    jfields = [(f.name, f.default)
               for f in dataclasses.fields(jgen.InferenceParams)]
    assert fields == jfields
    p = InferenceParams(max_seqlen=64, max_batch_size=2)
    assert p.caches is None and p.seqlen_offset == 0
