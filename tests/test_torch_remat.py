"""Port parity: rematerialised training (``GPTConfig.remat``).

`tests/models/test_remat_policy.py`'s tiny fp32 config: the JAX package
initialises it, `state_dict_from_jax` carries the parameters into the port,
and the same numpy token ids go through both (JAX: Pallas in interpret
mode; port: the plain versions on the CPU). One JAX gradient (no remat) is
shared by every policy.

  * the gradients of (logits ** 2).mean() under each policy ("nothing",
    "save_attn", "save_dots") equal the port's without remat and the JAX
    package's (atol 1e-5, rtol 1e-4, that test's tolerances);
  * the attention forward runs once per layer less under "save_attn" than
    under "nothing" (the saved (out, lse) replace its recompute), and as
    often as without remat; the packed-heads route the same, its gradients
    equal to its own without remat (its JAX parity without remat is
    tests/test_torch_train.py's);
  * the Trainer takes `experiment/pile/gpt3m-flash-8k.yaml` (remat: true)
    with tiny overrides, and its step equals the same step without remat.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.models.gpt import GPTConfig as JGPTConfig
from xhy_flash_attention_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from xhy_flash_attention_tpu_torch import (GPTConfig, GPTLMHeadModel,
                                           state_dict_from_jax)
from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd as tfwd
from xhy_flash_attention_tpu_torch.training import load_config
from xhy_flash_attention_tpu_torch.training.train import Trainer

LAYERS = 2
TINY = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=LAYERS,
    num_attention_heads=4, intermediate_size=128, max_position_embeddings=0,
    rotary_emb_fraction=1.0, rms_norm=True, activation_function="swiglu",
    tie_word_embeddings=False, qkv_proj_bias=False, out_proj_bias=False,
    mlp_fc1_bias=False, mlp_fc2_bias=False)
# h == hk, no rotary, (h d) % 128 == 0: MHA's packed-heads route
PACKED = dict(TINY, hidden_size=128, num_attention_heads=2,
              rotary_emb_fraction=0.0, max_position_embeddings=128)
CONFIGS = {"flash_attention": TINY, "packed": PACKED}
POLICIES = ("nothing", "save_attn", "save_dots")
RECIPE = (pathlib.Path(__file__).resolve().parents[1] / "xhy_flash_attention_tpu"
          / "training" / "configs" / "experiment" / "pile"
          / "gpt3m-flash-8k.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(params as numpy, ids, JAX gradients as the port's state dict)."""
    ids = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(np.int32)
    cfg = JGPTConfig(**CONFIGS[name], dtype=jnp.float32)
    model = JGPTLMHeadModel(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))

    def loss(p):
        logits, _ = model.apply(p, jnp.asarray(ids))
        return (logits.astype(jnp.float32) ** 2).mean()

    grads = jax.device_get(jax.grad(loss)(params))
    port_cfg = GPTConfig(**CONFIGS[name])
    return (jax.device_get(params), ids,
            state_dict_from_jax(grads, port_cfg))


def _port_grads(name, **remat):
    cfg = GPTConfig(**CONFIGS[name], **remat)
    model = GPTLMHeadModel(cfg, device="cpu")
    if name == "flash_attention":
        params, ids, _ = _jax(name)
        model.load_state_dict(state_dict_from_jax(params, cfg))
    else:
        ids = np.random.default_rng(1).integers(0, 128, (2, 64))
    logits, _ = model(torch.from_numpy(ids).long())
    (logits.float() ** 2).mean().backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts the attention forward's plain version, which every route
    (flash_attention, packed heads) runs on the CPU."""
    calls = [0]
    real = tfwd.attention_fwd_ref

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(tfwd, "attention_fwd_ref", spy)
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads
    monkeypatch.setattr(fused_heads, "attention_fwd_ref", spy)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_match_no_remat_and_jax(policy):
    _, _, want = _jax("flash_attention")
    plain = _port_grads("flash_attention")
    got = _port_grads("flash_attention", remat=True, remat_policy=policy)
    assert set(got) == set(plain) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), plain[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_save_attn_elides_the_forward_recompute(name, attention_calls):
    counts, grads = {}, {}
    for policy in (None,) + POLICIES:
        attention_calls[0] = 0
        grads[policy] = _port_grads(name, **({} if policy is None else dict(
            remat=True, remat_policy=policy)))
        counts[policy] = attention_calls[0]
    for policy in POLICIES:
        for n, g in grads[policy].items():
            np.testing.assert_allclose(g.numpy(), grads[None][n].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=n)
    assert counts[None] == LAYERS, counts
    assert counts["nothing"] == 2 * LAYERS, counts
    assert counts["save_attn"] == counts["nothing"] - LAYERS, counts
    assert counts["save_dots"] == counts["save_attn"], counts


def test_remat_needs_a_known_policy():
    with pytest.raises(ValueError, match="remat_policy"):
        GPTConfig(**TINY, remat=True, remat_policy="dots")


def test_tape_replay_checks_the_query():
    """A recompute takes the saved (out, lse) in turn without a launch,
    raises on a call whose query is not the saved call's, and runs the
    call again once the tape is empty (a second backward)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.remat import (
        _tape_mode, saved_attention)
    q = torch.zeros(1, 4, 2, 8)
    saved = (torch.ones(1, 4, 2, 8), torch.ones(1, 2, 4))
    fresh = (torch.zeros(1, 4, 2, 8), torch.zeros(1, 2, 4))
    tape = []
    with _tape_mode("record", tape):
        for _ in range(2):
            out, lse = saved_attention(lambda: saved, q)
            assert out is saved[0] and lse is saved[1]

    def launch():
        raise AssertionError("a replayed call launched")
    with _tape_mode("replay", tape):
        out, lse = saved_attention(launch, q)
        assert torch.equal(out, saved[0]) and torch.equal(lse, saved[1])
        with pytest.raises(RuntimeError, match="not the saved call"):
            saved_attention(launch, q.double())
        assert not tape
        out, lse = saved_attention(lambda: fresh, q)
        assert out is fresh[0] and lse is fresh[1]


def test_trainer_takes_the_8k_recipe(tmp_path):
    """gpt3m-flash-8k.yaml sets remat: true; at tiny size its step equals
    the same step with remat off, bit for bit (the same plain ops run in
    the same order; the recompute only repeats them)."""
    toks = np.random.default_rng(0).integers(0, 256, 4000)
    path = tmp_path / "train.bin"
    toks.astype(np.uint16).tofile(path)
    over = {"model.hidden_size": 64, "model.num_hidden_layers": 2,
            "model.num_attention_heads": 4, "model.vocab_size": 256,
            "data.seqlen": 64, "data.batch_size": 2, "data.path": str(path),
            "dtype": "float32", "max_steps": 1, "ckpt_every": 0,
            "ckpt_dir": str(tmp_path / "ckpt")}
    results = {}
    for remat in (True, False):
        cfg = load_config(RECIPE, {**over, "model.remat": remat})
        trainer = Trainer(cfg, device="cpu")
        assert trainer.model_cfg.remat is remat
        assert trainer.model_cfg.remat_policy == "save_attn"
        trainer.init_params()
        ids, labels = trainer._batch(*next(iter(trainer.data)))
        results[remat] = trainer.compute_grads(ids, labels)
    (loss_r, grads_r), (loss_p, grads_p) = results[True], results[False]
    assert torch.equal(loss_r, loss_p)
    for name, g in grads_r.items():
        assert torch.equal(g, grads_p[name]), name
