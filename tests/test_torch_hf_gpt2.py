"""Port parity: GPT-2 from Hugging Face and Megatron-LM weights, and an fp32
MHA off the packed-heads route, against HF ``transformers`` and the JAX
package.

The tiny GPT-2 of tests/models/test_gpt.py (vocab 211, 128 positions, width
128, 2 layers, 4 heads) is built locally from a config object (nothing
downloaded); its state_dict goes through the port's and the JAX package's
``remap_state_dict_hf_gpt2``, and the same token ids through all three
models in fp32 on the CPU (the JAX package's Pallas kernels in interpret
mode, the port's plain versions). Tolerances: 1e-4 absolute on the logits
(tests/test_torch_model.py's bound against the JAX model), the remaps bit
for bit against ``state_dict_from_jax`` of the JAX package's trees.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.gpt import (
    gpt2_config_to_gpt_config as jgpt2_config,
    remap_state_dict_hf_gpt2 as jremap_hf,
    remap_state_dict_megatron as jremap_megatron,
)
from xhy_flash_attention_tpu.modules.mha import MHA as JMHA
from xhy_flash_attention_tpu_torch import (
    GPTConfig,
    GPTLMHeadModel,
    gpt2_config_to_gpt_config,
    remap_state_dict_hf_gpt2,
    remap_state_dict_megatron,
    state_dict_from_jax,
)
from xhy_flash_attention_tpu_torch.modules.mha import MHA

transformers = pytest.importorskip("transformers")

TOL = 1e-4
SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_config(pdrop=0.0):
    return transformers.GPT2Config(
        vocab_size=211, n_positions=128, n_embd=128, n_layer=2, n_head=4,
        resid_pdrop=pdrop, embd_pdrop=pdrop, attn_pdrop=pdrop)


@functools.lru_cache(maxsize=None)
def _hf():
    """(HF config, HF model in eval mode, ids, HF logits)."""
    cfg = _hf_config()
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(cfg).eval()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, SEQ))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.numpy()
    return cfg, model, ids, ref


@functools.lru_cache(maxsize=None)
def _jax_hf():
    """The JAX package's remapped tree (numpy) and its logits: one JAX
    call for the module."""
    cfg, model, ids, _ = _hf()
    jcfg = jgpt2_config(cfg)
    params = jremap_hf({k: v.numpy() for k, v in model.state_dict().items()},
                       jcfg)
    logits, _ = JGPTLMHeadModel(jcfg).apply(params, jnp.asarray(ids, jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(logits)


def _port(hf_cfg, state_dict):
    cfg = gpt2_config_to_gpt_config(hf_cfg)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(remap_state_dict_hf_gpt2(state_dict, cfg))
    return cfg, model.eval()


def test_gpt2_config_translation_matches_jax():
    hf_cfg = _hf_config(0.1)
    got, want = gpt2_config_to_gpt_config(hf_cfg), jgpt2_config(hf_cfg)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size",
                  "max_position_embeddings", "activation_function",
                  "layer_norm_epsilon", "embd_pdrop", "resid_pdrop",
                  "attn_pdrop", "tie_word_embeddings"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.float32 and got.embd_pdrop == 0.1


@pytest.mark.parametrize("weights", ["numpy", "torch"])
def test_gpt2_remap_matches_jax_bit_for_bit(weights):
    hf_cfg, model, _, _ = _hf()
    sd = model.state_dict()
    if weights == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    cfg = gpt2_config_to_gpt_config(hf_cfg)
    got = remap_state_dict_hf_gpt2(sd, cfg)
    want = state_dict_from_jax(_jax_hf()[0], cfg)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_gpt2_logits_match_hf_and_jax():
    hf_cfg, model, ids, ref = _hf()
    _, port = _port(hf_cfg, model.state_dict())
    with torch.inference_mode():
        got, _ = port(torch.tensor(ids))
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _jax_hf()[1], rtol=0, atol=TOL)


def test_gpt2_decode_matches_prefill():
    """A prefill of 16 tokens into dense caches, then 8 decode steps,
    against one forward over all 24 (≙ tests/models/test_gpt.py)."""
    hf_cfg, model, ids, _ = _hf()
    _, port = _port(hf_cfg, model.state_dict())
    ids = torch.tensor(ids[:1, :24])
    with torch.inference_mode():
        full, _ = port(ids)
        caches = port.allocate_kv_caches(1, 64)
        pre, caches = port(ids[:, :16], kv_caches=caches, seqlen_offset=0)
        steps = []
        for t in range(16, 24):
            out, caches = port(ids[:, t:t + 1], kv_caches=caches,
                               seqlen_offset=t)
            steps.append(out[:, 0])
    np.testing.assert_allclose(pre.numpy(), full[:, :16].numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               full[:, 16:].numpy(), rtol=0, atol=TOL)


def test_gpt2_dropout_fields():
    """Published GPT-2 configs set every pdrop to 0.1: kept in the config;
    a deterministic forward ignores them (as the JAX model's default
    deterministic=True does). A non-deterministic forward of that config
    raises the JAX model's ValueError in both packages (the JAX GPTModel
    hands its blocks no seed for the embedding and residual dropout); with
    attention dropout alone it runs, each layer's seed drawn from the
    caller's generator: the same generator seed repeats the logits, and
    they differ from the deterministic ones."""
    hf_cfg, model, ids, _ = _hf()
    cfg, port = _port(_hf_config(0.1), model.state_dict())
    assert (cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop) == (0.1,) * 3
    _, plain = _port(hf_cfg, model.state_dict())
    x = torch.tensor(ids[:, :16])
    with torch.inference_mode():
        got, _ = port(x, deterministic=True)
        want, _ = plain(x)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="dropout_p > 0 requires a seed"):
            port(x, deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(0))
        plain(x, deterministic=False)  # no pdrop: nothing to drop
    jcfg = jgpt2_config(_hf_config(0.1))
    with pytest.raises(ValueError, match="dropout_p > 0 requires a seed"):
        JGPTLMHeadModel(jcfg).apply(
            _jax_hf()[0], jnp.asarray(ids[:, :16], jnp.int32),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    attn = transformers.GPT2Config(**{**_hf_config().to_dict(),
                                      "attn_pdrop": 0.1})
    _, port = _port(attn, model.state_dict())
    with torch.inference_mode():
        runs = [port(x, deterministic=False,
                     dropout_generator=torch.Generator().manual_seed(s))[0]
                for s in (1, 1, 2)]
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], want)


MEGATRON = dict(h=4, d=16, hidden=64, vocab=100, layers=2, inner=128,
                positions=32)


@functools.lru_cache(maxsize=None)
def _megatron():
    """(config kwargs, a Megatron-LM state dict of numpy arrays, ids, the
    JAX tree (numpy) and the JAX logits) of tests/models/test_gpt.py's
    test_megatron_remap_shapes; the vocabulary padded to a multiple of
    16."""
    m = MEGATRON
    hid, inner = m["hidden"], m["inner"]
    kw = dict(vocab_size=m["vocab"], hidden_size=hid,
              num_hidden_layers=m["layers"], num_attention_heads=m["h"],
              intermediate_size=inner, max_position_embeddings=m["positions"],
              pad_vocab_size_multiple=16)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"language_model.embedding.word_embeddings.weight":
          rand(m["vocab"], hid),
          "language_model.embedding.position_embeddings.weight":
          rand(m["positions"], hid),
          "language_model.encoder.final_layernorm.weight": 1 + rand(hid) / 10,
          "language_model.encoder.final_layernorm.bias": rand(hid) / 10}
    for i in range(m["layers"]):
        p = f"language_model.encoder.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[p + norm + ".weight"] = 1 + rand(hid) / 10
            sd[p + norm + ".bias"] = rand(hid) / 10
        for name, (out, inp) in (
                ("self_attention.query_key_value", (3 * hid, hid)),
                ("self_attention.dense", (hid, hid)),
                ("mlp.dense_h_to_4h", (inner, hid)),
                ("mlp.dense_4h_to_h", (hid, inner))):
            sd[p + name + ".weight"] = rand(out, inp) / np.sqrt(inp)
            sd[p + name + ".bias"] = rand(out) / 10
    ids = rng.integers(0, m["vocab"], (1, 16))
    jcfg = JGPTConfig(**kw, dtype=jnp.float32)
    params = jremap_megatron(sd, jcfg)
    logits, _ = JGPTLMHeadModel(jcfg).apply(params, jnp.asarray(ids, jnp.int32))
    return (kw, sd, ids, jax.tree_util.tree_map(np.asarray, params),
            np.asarray(logits))


def test_megatron_remap_matches_jax_bit_for_bit():
    kw, sd, ids, jparams, jlogits = _megatron()
    cfg = GPTConfig(**kw)
    got = remap_state_dict_megatron(sd, cfg)
    want = state_dict_from_jax(jparams, cfg)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # Wqkv de-interleaved: q rows of head 0 are Megatron's rows 0:d
    d = MEGATRON["d"]
    wqkv = sd["language_model.encoder.layers.0.self_attention."
              "query_key_value.weight"]
    assert torch.equal(got["transformer.layers.0.mixer.Wqkv.weight"][:d],
                       torch.from_numpy(wqkv[:d]))
    assert got["transformer.embeddings.word_embeddings.weight"].shape[0] == \
        cfg.padded_vocab_size
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(got)
    with torch.inference_mode():
        logits, _ = model(torch.tensor(ids))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=TOL)


def test_megatron_remap_cuts_a_longer_vocabulary():
    kw, sd, _, _, _ = _megatron()
    cfg = GPTConfig(**dict(kw, vocab_size=80, pad_vocab_size_multiple=1))
    got = remap_state_dict_megatron(sd, cfg)
    emb = sd["language_model.embedding.word_embeddings.weight"]
    assert torch.equal(got["transformer.embeddings.word_embeddings.weight"],
                       torch.from_numpy(emb[:80]))


def test_fp32_mha_off_the_packed_route_matches_jax():
    """h d = 320, not a multiple of 128: MHA takes flash_attention, not the
    packed-heads route (GPT-2 XL's 1600 the same way), in fp32, causal,
    against the JAX MHA on the same weights."""
    h, d, b, s = 5, 64, 2, 40
    e = h * d
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    jmha = JMHA(embed_dim=e, num_heads=h, causal=True, dtype=jnp.float32)
    params = jmha.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, _ = jmha.apply(params, jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    mha = MHA(e, h, causal=True, device="cpu")
    mha.load_state_dict({
        "Wqkv.weight": torch.from_numpy(p["Wqkv"]["kernel"].T.copy()),
        "Wqkv.bias": torch.from_numpy(p["Wqkv"]["bias"].copy()),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"].copy())})
    with torch.inference_mode():
        got, _ = mha(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
