"""Port parity: training on one device against the JAX package's Trainer.

The same token file (made with numpy) and the same parameters (the JAX
Trainer's flax init, carried across by `state_dict_from_jax`) go through
the JAX `Trainer` (Pallas kernels in interpret mode on the CPU) and the
port's `Trainer` on the CPU (plain versions), in fp32, for 3 steps of
clip -> AdamW with a warmup schedule. Both attention routes are covered at
tiny size, each in the layout of the recipe that runs it: hidden 64 with
4 heads ((h·d) % 128 != 0) and rotary on half the head dim (T-long's
layout) takes the general `flash_attention`; hidden 128 with 2 heads and
learned positions (T-packed's layout) the packed kernels. Both carry
LayerNorm with bias, so `state_dict_from_jax` is checked on both layouts.
Tolerances: losses within 2e-5 (relative), step-1 gradients within 2e-4 of
each gradient's largest entry (two fp32 backward passes that sum in other
orders), final parameters within 2e-5 absolute (three updates of at most
lr = 1e-3 each, whose Adam normalisation can amplify the noise of the
smallest gradient entries).

Also: bitwise exact resume from a checkpoint, the data windows against the
JAX package's (native and numpy), the YAML reader against
``yaml.safe_load`` on every config file of the JAX package, and the
schedule and optimizer formulas against optax.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from xhy_flash_attention_tpu.training import config as jconfig
from xhy_flash_attention_tpu.training import data as jdata
from xhy_flash_attention_tpu.training import optim as joptim
from xhy_flash_attention_tpu.training.train import Trainer as JTrainer
from xhy_flash_attention_tpu_torch.models.gpt import state_dict_from_jax
from xhy_flash_attention_tpu_torch.training import config as tconfig
from xhy_flash_attention_tpu_torch.training import data as tdata
from xhy_flash_attention_tpu_torch.training import optim as toptim
from xhy_flash_attention_tpu_torch.training.train import Trainer, train

CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1]
                  / "xhy_flash_attention_tpu" / "training" / "configs"
                  ).rglob("*.yaml"))
SEQ, BATCH, STEPS = 64, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    # a learnable pattern plus noise, from a seed
    rng = np.random.default_rng(0)
    toks = (np.arange(40_000) % 251 + rng.integers(0, 3, 40_000)) % 256
    path = tmp_path_factory.mktemp("tokens") / "train.bin"
    toks.astype(np.uint16).tofile(path)
    return str(path)


def _cfg(mod, token_file, tmpdir, hidden, heads, rotary=False, **kw):
    positions = (dict(max_position_embeddings=0, rotary_emb_fraction=0.5)
                 if rotary else dict(max_position_embeddings=SEQ))
    return mod.TrainConfig(
        model=dict(vocab_size=256, hidden_size=hidden, num_hidden_layers=2,
                   num_attention_heads=heads, intermediate_size=2 * hidden,
                   **positions),
        optimizer=mod.OptimizerConfig(lr=1e-3, weight_decay=0.01,
                                      grad_clip=1.0),
        scheduler=mod.SchedulerConfig(warmup_steps=2, total_steps=40),
        data=mod.DataConfig(path=token_file, seqlen=SEQ, batch_size=BATCH),
        max_steps=kw.pop("max_steps", STEPS), log_every=100,
        ckpt_every=kw.pop("ckpt_every", 0), ckpt_dir=str(tmpdir),
        dtype="float32", **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("hidden,heads,rotary", [(64, 4, True),
                                                  (128, 2, False)],
                         ids=["flash_attention", "packed_heads"])
def test_three_steps_match_jax(token_file, tmp_path, hidden, heads, rotary):
    jt = JTrainer(_cfg(jconfig, token_file, tmp_path / "j", hidden, heads,
                       rotary))
    jt.init_params()
    params0 = jax.device_get(jt.params)
    batches = [next(iter(jdata.LMDataModule(token_file, SEQ, BATCH,
                                            step=i))) for i in range(STEPS)]
    jgrads = jax.grad(jt._loss_fn)(jt.params, *map(jnp.asarray, batches[0]))
    step_fn = jt._build_step()
    params, opt_state, jlosses = jt.params, jt.opt_state, []
    for ids, labels in batches:
        params, opt_state, loss, _ = step_fn(params, opt_state,
                                             jnp.asarray(ids),
                                             jnp.asarray(labels))
        jlosses.append(float(loss))

    tt = Trainer(_cfg(tconfig, token_file, tmp_path / "t", hidden, heads,
                      rotary), device="cpu")
    tt.init_params(state_dict_from_jax(params0, tt.model_cfg))
    _, tgrads = tt.compute_grads(*tt._batch(*batches[0]))
    want = state_dict_from_jax(jax.device_get(jgrads), tt.model_cfg)
    assert set(tgrads) == set(want)
    for name, g in tgrads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= 2e-4, name

    tt.fit(log=lambda *_: None)
    got_losses = [h["loss"] for h in tt.history]
    np.testing.assert_allclose(got_losses, jlosses, rtol=2e-5)
    final = state_dict_from_jax(jax.device_get(params), tt.model_cfg)
    for name, p in tt.params.items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_checkpoint_resume_bitwise(token_file, tmp_path):
    cfg = _cfg(tconfig, token_file, tmp_path, 64, 4, ckpt_every=3,
               max_steps=6)
    t1 = Trainer(cfg, device="cpu")
    t1.fit(log=lambda *_: None)
    t2 = Trainer(_cfg(tconfig, token_file, tmp_path, 64, 4, max_steps=6),
                 device="cpu")
    assert t2.maybe_resume() and t2.step == 6  # last.ckpt is step 6
    t3 = Trainer(_cfg(tconfig, token_file, tmp_path, 64, 4, max_steps=6),
                 device="cpu")
    t3.load_checkpoint(os.path.join(str(tmp_path), "step_3.ckpt"))
    assert t3.step == 3 and t3.data.step == 3
    t3.fit(log=lambda *_: None)
    for name, p in t1.params.items():
        assert torch.equal(p, t3.params[name]), name
        assert torch.equal(p, t2.params[name]), name
    assert t3.num_tokens.count == t1.num_tokens.count == 6 * BATCH * SEQ


def test_train_entry_reads_a_recipe(token_file, tmp_path):
    """train() on a repository recipe, cut to a tiny model by overrides."""
    recipe = [p for p in CONFIGS if p.name == "gpt2s-flash.yaml"
              and p.parent.name == "owt"][0]
    t = train(str(recipe), device="cpu", log=lambda *_: None,
              **{"data.path": token_file, "data.seqlen": SEQ,
                 "data.batch_size": 2, "model.hidden_size": 64,
                 "model.num_hidden_layers": 1, "model.num_attention_heads": 2,
                 "model.vocab_size": 256, "model.pad_vocab_size_multiple": 8,
                 "max_steps": 2, "ckpt_every": 0, "ckpt_dir": str(tmp_path),
                 "dtype": "float32"})
    assert t.step == 2 and len(t.history) == 2
    assert all(np.isfinite(h["loss"]) for h in t.history)
    assert t.model_cfg.max_position_embeddings == SEQ  # ${data.seqlen}
    assert t.opt.lr(0) == 0.0  # the warmup starts at 0, as optax's


@pytest.mark.parametrize("kw", [dict(mesh=(2, 1)), dict(pipeline_parallel=2),
                                dict(task="image")])
def test_unported_training_options_raise(token_file, tmp_path, kw):
    # the vision trainer comes with slice 8, parallel training with slice 9
    with pytest.raises(NotImplementedError,
                       match="slice 8" if "task" in kw else "slice 9"):
        Trainer(_cfg(tconfig, token_file, tmp_path, 64, 4, **kw),
                device="cpu")


@pytest.mark.parametrize("use_native", [True, False])
def test_data_windows_match_jax(token_file, use_native):
    try:
        got = tdata.TokenDataset(token_file, SEQ - 1, seed=3,
                                 use_native=use_native)
    except RuntimeError:
        pytest.skip("g++ unavailable")
    want = jdata.TokenDataset(token_file, SEQ - 1, seed=3, use_native=False)
    n = want.num_sequences
    assert got.num_sequences == n
    for start, batch in ((0, 8), (17, 32), (2 * n + 5, 16)):
        np.testing.assert_array_equal(got.fetch(start, batch),
                                      want.fetch(start, batch))
    assert {tdata._feistel_perm_np(i, n, 3) for i in range(n)} == set(range(n))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml(path):
    text = path.read_text()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    got = tconfig.load_config(path, {"data.path": "x.bin", "max_steps": 7})
    want = jconfig.load_config(path, {"data.path": "x.bin", "max_steps": 7})
    assert got.__dict__.keys() == want.__dict__.keys()
    for key, value in want.__dict__.items():
        value = value.__dict__ if hasattr(value, "__dict__") else value
        other = getattr(got, key)
        other = other.__dict__ if hasattr(other, "__dict__") else other
        assert other == value, key


@pytest.mark.parametrize("name", ["cosine_warmup", "linear_warmup",
                                  "constant"])
def test_schedule_matches_optax(name):
    cfg_t = tconfig.SchedulerConfig(name=name, warmup_steps=5,
                                    total_steps=30, min_lr_ratio=0.1)
    cfg_j = jconfig.SchedulerConfig(name=name, warmup_steps=5,
                                    total_steps=30, min_lr_ratio=0.1)
    got = toptim.make_schedule(cfg_t)
    want = joptim.make_schedule(cfg_j)
    for count in range(0, 40):
        assert abs(got(count) - float(want(count))) <= 1e-6, count


@pytest.mark.parametrize("clip", [0.05, 100.0], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(clip):
    """Three updates of clip -> AdamW (masked decay) against the optax
    chain, on fp32 leaves: within 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"w.weight": (8, 4), "w.bias": (8,), "norm.weight": (4,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    sched = dict(warmup_steps=1, total_steps=10)
    opt_t = toptim.make_optimizer(tconfig.OptimizerConfig(**kw),
                                  tconfig.SchedulerConfig(**sched))
    jparams = {n.replace(".", "_"): {"kernel" if p.ndim == 2 else
                                     ("bias" if n.endswith("bias") else
                                      "weight"): jnp.asarray(p)}
               for n, p in params.items()}
    opt_j = joptim.make_optimizer(jconfig.OptimizerConfig(**kw),
                                  jconfig.SchedulerConfig(**sched))
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    state_t, state_j = opt_t.init(tparams), opt_j.init(jparams)
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        jgrads = jax.tree.map(
            lambda _, g: jnp.asarray(g),
            jparams, {n.replace(".", "_"): {k: grads[n] for k in
                                            jparams[n.replace(".", "_")]}
                      for n in grads})
        opt_t.update({n: torch.from_numpy(g) for n, g in grads.items()},
                     state_t, tparams)
        upd, state_j = opt_j.update(jgrads, state_j, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for n, p in tparams.items():
        (want,) = jparams[n.replace(".", "_")].values()
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=n)
