"""Port parity: the transformer Block against the JAX package's flax Block
with the same weights and seeds: prenorm and postnorm, the tied and untied
parallel blocks, residual dropout (the fused norm's keep mask) and
attention dropout (an explicit seed), forward and gradients, the weights
carried by `state_dict_from_jax`. The JAX side runs its Pallas kernels in
interpret mode on the CPU; the port's CPU tensors take the plain versions.
fp32 throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.modules.block import Block as JBlock
from xhy_flash_attention_tpu.modules.mha import MHA as JMHA
from xhy_flash_attention_tpu.modules.mlp import Mlp as JMlp
from xhy_flash_attention_tpu_torch.models.gpt import (GPTConfig,
                                                      state_dict_from_jax)
from xhy_flash_attention_tpu_torch.modules.block import Block
from xhy_flash_attention_tpu_torch.modules.mha import MHA
from xhy_flash_attention_tpu_torch.modules.mlp import Mlp

B, S, E, H = 2, 32, 128, 2
SEEDS = (91, 92)
ATTN_SEED = 93


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _SeededMHA(JMHA):
    """The JAX MHA with its attention dropout keyed on a fixed seed (the
    JAX Block hands its mixer none)."""

    seed: int = ATTN_SEED

    def __call__(self, x, *args, **kw):
        return super().__call__(x, *args, dropout_seed=self.seed, **kw)


def _blocks(kind, p_resid, p_attn):
    prenorm = kind != "postnorm"
    par = kind.startswith("parallel")
    tied = kind != "parallel_untied"
    mixer = functools.partial(_SeededMHA, embed_dim=E, num_heads=H,
                              causal=True, dropout=p_attn, dtype=jnp.float32)
    mlp = functools.partial(JMlp, hidden_features=2 * E)
    jblock = JBlock(dim=E, mixer=mixer, mlp=mlp, prenorm=prenorm,
                    resid_dropout1=p_resid, resid_dropout2=p_resid,
                    residual_in_fp32=True, parallel_block=par,
                    parallel_block_tied_norm=tied)
    block = Block(E, MHA(E, H, causal=True, dropout=p_attn, device="cpu"),
                  Mlp(E, 2 * E, device="cpu"), prenorm=prenorm,
                  resid_dropout1=p_resid, resid_dropout2=p_resid,
                  residual_in_fp32=True, parallel_block=par,
                  parallel_block_tied_norm=tied, device="cpu")
    return jblock, block


def _load(block, params, kind):
    """The flax Block's parameters into the port's Block through
    state_dict_from_jax (a one-layer GPT tree around them)."""
    cfg = GPTConfig(hidden_size=E, num_hidden_layers=1, num_attention_heads=H,
                    prenorm=kind != "postnorm",
                    parallel_block=kind.startswith("parallel"),
                    parallel_block_tied_norm=kind != "parallel_untied")
    tree = {"wte": {"embedding": np.zeros((8, E), np.float32)},
            "transformer": {"layers_0": params["params"]}}
    pre = "transformer.layers.0."
    sd = {k[len(pre):]: v for k, v in state_dict_from_jax(tree, cfg).items()
          if k.startswith(pre)}
    block.load_state_dict(sd)
    return sd


# (kind, residual dropout, attention dropout, residual in)
CASES = [
    ("prenorm", 0.15, 0.1, True),
    ("postnorm", 0.15, 0.0, False),
    ("parallel_tied", 0.15, 0.1, False),
    ("parallel_untied", 0.15, 0.0, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-attn{c[2]}"
                         + ("-res" if c[3] else ""))
def test_block_matches_jax(case):
    kind, p_resid, p_attn, has_res = case
    rng = np.random.default_rng(len(kind))
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    res = (rng.standard_normal((B, S, E)) if has_res else np.zeros(
        (B, S, E))).astype(np.float32)
    jblock, block = _blocks(kind, p_resid, p_attn)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = _load(block, params, kind)
    assert ("norm2.weight" in sd) == (kind != "parallel_tied")
    prenorm = kind != "postnorm"
    res_in = has_res and prenorm

    def jrun(params_, x_, res_):
        hidden, residual, _ = jblock.apply(
            params_, x_, res_ if res_in else None, False, SEEDS)
        return (hidden, residual) if prenorm else hidden
    want, vjp = jax.vjp(jrun, params, jnp.asarray(x), jnp.asarray(res))
    dh = rng.standard_normal((B, S, E)).astype(np.float32)
    dr = rng.standard_normal((B, S, E)).astype(np.float32)
    jg_params, jg_x, jg_res = vjp(
        (jnp.asarray(dh), jnp.asarray(dr)) if prenorm else jnp.asarray(dh))

    xt = torch.from_numpy(x).requires_grad_()
    rt = torch.from_numpy(res).requires_grad_()
    hidden, residual, _ = block(
        xt, rt if res_in else None, deterministic=False,
        dropout_seed=ATTN_SEED if p_attn else None, seeds=SEEDS)
    outs = (hidden, residual) if prenorm else (hidden,)
    wants = want if prenorm else (want,)
    for got, wt, what in zip(outs, wants, ("hidden", "residual")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(wt),
                                   rtol=0, atol=2e-5, err_msg=what)
    cots = (torch.from_numpy(dh), torch.from_numpy(dr))[:len(outs)]
    named = dict(block.named_parameters())
    leaves = [xt] + ([rt] if res_in else []) + list(named.values())
    grads = torch.autograd.grad(outs, leaves, cots)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x), rtol=1e-5,
                               atol=4e-5, err_msg="dx")
    if res_in:
        np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg_res),
                                   rtol=1e-5, atol=4e-5, err_msg="dresidual")
    # the parameters' gradients, carried over as the weights were
    jsd = _load(block, jg_params, kind)
    for g, name in zip(grads[1 + res_in:], named):
        np.testing.assert_allclose(g.numpy(), jsd[name].numpy(), rtol=1e-5,
                                   atol=2e-4, err_msg=name)
    # the same call deterministic differs: the residual dropout ran
    with torch.no_grad():
        plain, _, _ = block(xt, rt if res_in else None, seeds=SEEDS)
    assert not torch.allclose(plain, hidden, atol=1e-3)


def test_residual_dropout_needs_a_seed():
    """deterministic=False with a residual rate and no seed raises the JAX
    package's ValueError, on both sides."""
    x = np.random.default_rng(0).standard_normal((1, 8, E)).astype(
        np.float32)
    jblock, block = _blocks("prenorm", 0.1, 0.0)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="requires a seed"):
        jblock.apply(params, jnp.asarray(x), None, False, (None, None))
    with pytest.raises(ValueError, match="requires a seed"):
        block(torch.from_numpy(x), None, deterministic=False)
    block(torch.from_numpy(x), None)  # deterministic: no seed needed
