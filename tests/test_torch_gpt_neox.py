"""Port parity: GPT-NeoX (Pythia) from Hugging Face weights, against HF
``transformers`` and the JAX package.

The tiny configs of tests/models/test_adapters.py (vocab 173, width 128, 2
layers, 4 heads of 32, the parallel residual on and off, rotary_pct 0.25
and 1.0) are built locally from config objects (nothing downloaded); the HF
state_dict goes through the port's and the JAX package's
``remap_state_dict_hf_gpt_neox``, and the same ids through all three models
in fp32 on the CPU (the JAX package's Pallas kernels in interpret mode, the
port's plain versions). Tolerances: the remap bit for bit against
``state_dict_from_jax`` of the JAX tree; logits within 3e-3 of HF's (the
adapters test's ``_compare``: HF's exact GELU against the tanh form) and of
the JAX model's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu.models.gpt_neox import (
    gpt_neox_config_to_gpt_config as jneox_config,
    remap_state_dict_hf_gpt_neox as jremap,
)
from xhy_flash_attention_tpu_torch import (
    GPTLMHeadModel,
    gpt_neox_config_to_gpt_config,
    remap_state_dict_hf_gpt_neox,
    state_dict_from_jax,
)

transformers = pytest.importorskip("transformers")

TOL = 3e-3
SEQ = 48


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf(parallel, rotary_pct):
    cfg = transformers.GPTNeoXConfig(
        vocab_size=173, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256, rotary_pct=rotary_pct,
        max_position_embeddings=128, use_parallel_residual=parallel,
        hidden_act="gelu", tie_word_embeddings=False,
        attention_dropout=0.0, hidden_dropout=0.0)
    torch.manual_seed(0)
    return cfg, transformers.GPTNeoXForCausalLM(cfg).eval()


@pytest.mark.parametrize("rotary_pct", [0.25, 1.0])
@pytest.mark.parametrize("parallel", [True, False])
def test_gpt_neox_logits_match_hf_and_jax(parallel, rotary_pct):
    hf_cfg, hf_model = _hf(parallel, rotary_pct)
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    cfg = gpt_neox_config_to_gpt_config(hf_cfg)
    jcfg = jneox_config(hf_cfg)
    assert (cfg.parallel_block, cfg.parallel_block_tied_norm,
            cfg.rotary_emb_fraction, cfg.activation_function) == (
        jcfg.parallel_block, jcfg.parallel_block_tied_norm,
        jcfg.rotary_emb_fraction, jcfg.activation_function)
    ours = remap_state_dict_hf_gpt_neox(sd, cfg)
    jparams = jremap(sd, jcfg)
    want_sd = state_dict_from_jax(jparams, cfg)
    assert ours.keys() == want_sd.keys()
    for k in ours:
        assert torch.equal(ours[k], want_sd[k]), k
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(ours)
    ids = np.random.default_rng(0).integers(0, hf_cfg.vocab_size, (2, SEQ))
    with torch.no_grad():
        ref = hf_model(torch.tensor(ids)).logits.numpy()
        got, _ = model(torch.from_numpy(ids))
    got = got.numpy()[..., :hf_cfg.vocab_size]
    jout, _ = JGPTLMHeadModel(jcfg).apply(jparams, jnp.asarray(ids, jnp.int32))
    jout = np.asarray(jout)[..., :hf_cfg.vocab_size]
    err_hf, err_jax = np.abs(got - ref).max(), np.abs(got - jout).max()
    assert err_hf < TOL, err_hf
    assert err_jax < TOL, err_jax


def test_gpt_neox_config_reads_rope_parameters():
    """A config in transformers 5's layout (no rotary_pct or
    rotary_emb_base; rope_parameters with partial_rotary_factor and
    rope_theta) gives the GPTConfig of the same config in the layout the
    JAX package reads; a config with neither fraction raises."""
    import types
    hf_cfg, _ = _hf(True, 0.25)
    fields = {k: getattr(hf_cfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size", "hidden_act",
        "layer_norm_eps", "initializer_range", "use_parallel_residual",
        "tie_word_embeddings")}
    new = types.SimpleNamespace(**fields, rope_parameters={
        "rope_type": "default", "rope_theta": 10000.0,
        "partial_rotary_factor": 0.25})
    assert gpt_neox_config_to_gpt_config(new) == \
        gpt_neox_config_to_gpt_config(hf_cfg)
    with pytest.raises(ValueError, match="rotary fraction"):
        gpt_neox_config_to_gpt_config(types.SimpleNamespace(**fields))


def test_gpt_neox_decode_matches_the_full_forward():
    """Partial rotary (rotary_pct 0.25) with the parallel block through the
    dense KV cache: a prefill then one decode step give the full forward's
    logits at those positions."""
    hf_cfg, hf_model = _hf(True, 0.25)
    cfg = gpt_neox_config_to_gpt_config(hf_cfg)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(remap_state_dict_hf_gpt_neox(
        hf_model.state_dict(), cfg))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, hf_cfg.vocab_size, (2, 17)))
    with torch.inference_mode():
        full, _ = model(ids)
        caches = model.allocate_kv_caches(2, 32)
        pre, caches = model(ids[:, :16], kv_caches=caches)
        step, _ = model(ids[:, 16:], kv_caches=caches, seqlen_offset=16)
    torch.testing.assert_close(pre, full[:, :16], rtol=0, atol=1e-5)
    torch.testing.assert_close(step, full[:, 16:], rtol=0, atol=1e-5)
