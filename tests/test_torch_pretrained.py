"""Port parity: utils/pretrained.py against the JAX package's.

``state_dict_from_pretrained`` reads a ``save_pretrained`` directory of a
tiny Hugging Face GPT-2 (built locally from a config object; nothing
downloaded), in safetensors and in ``pytorch_model.bin`` form, and must
return the JAX function's arrays; ``gpt_params_from_pretrained`` must give
the JAX package's config and, through ``state_dict_from_jax``, its
parameters bit for bit for GPT-2, Llama and GPT-NeoX, and refuse the
families whose models are not ported (slice 8) and unknown ones.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.utils import pretrained as jpre
from xhy_flash_attention_tpu_torch import GPTLMHeadModel, state_dict_from_jax
from xhy_flash_attention_tpu_torch.utils import pretrained as tpre

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models():
    """A tiny HF GPT-2, Llama and GPT-NeoX (random weights, eval mode)."""
    torch.manual_seed(0)
    gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=211, n_positions=64, n_embd=64, n_layer=2, n_head=4)).eval()
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2)).eval()
    neox = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, rotary_pct=0.25,
        tie_word_embeddings=False)).eval()
    return {"gpt2": gpt2, "llama": llama, "gpt_neox": neox}


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_state_dict_from_pretrained_reads_a_local_directory(tmp_path, safe):
    model = _models()["gpt2"]
    model.save_pretrained(tmp_path, safe_serialization=safe)
    got = tpre.state_dict_from_pretrained(str(tmp_path))
    want = jpre.state_dict_from_pretrained(str(tmp_path))
    assert got.keys() == want.keys() and got
    for key in want:
        assert isinstance(got[key], np.ndarray), key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_state_dict_from_pretrained_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpre.state_dict_from_pretrained(str(tmp_path))


@pytest.mark.parametrize("family", ["gpt2", "llama", "gpt_neox"])
def test_gpt_params_from_pretrained_matches_jax(tmp_path, family):
    """From a save_pretrained directory (the state dict read there) and
    from an in-memory state dict: the port's config fields and state dict
    against the JAX package's, bit for bit; then the model loads it."""
    model = _models()[family]
    model.save_pretrained(tmp_path)
    name = f"{tmp_path}/{family}-tiny"
    jcfg, jparams = jpre.gpt_params_from_pretrained(
        str(tmp_path), model.config)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    for source in (None, model.state_dict()):
        cfg, sd = tpre.gpt_params_from_pretrained(
            str(tmp_path) if source is None else name, model.config,
            state_dict=source)
        for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                      "num_attention_heads", "num_attention_heads_kv",
                      "intermediate_size",
                      "max_position_embeddings", "rms_norm",
                      "tie_word_embeddings", "layer_norm_epsilon",
                      "parallel_block", "parallel_block_tied_norm",
                      "rotary_emb_fraction"):
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert cfg.dtype == torch.float32
        want = state_dict_from_jax(jparams, cfg)
        want_keys = {k for k in want if not (
            cfg.tie_word_embeddings and k == "lm_head.weight")}
        assert sd.keys() == want_keys
        for key in want_keys:
            assert torch.equal(sd[key], want[key]), key
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(sd)


def test_gpt_params_from_pretrained_refusals():
    for family in ("opt", "gptj", "falcon"):
        cfg = types.SimpleNamespace(model_type=family)
        with pytest.raises(NotImplementedError, match="slice 8"):
            tpre.gpt_params_from_pretrained(f"org/{family}-tiny", cfg,
                                            state_dict={})
    with pytest.raises(ValueError, match="unsupported model family"):
        tpre.gpt_params_from_pretrained(
            "org/t5-small", types.SimpleNamespace(model_type="t5"),
            state_dict={})
    assert tpre.MODEL_FAMILIES == jpre.MODEL_FAMILIES
