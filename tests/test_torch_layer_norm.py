"""Port parity: the fused residual-add norm against the JAX package.

The same numpy inputs go through `xhy_flash_attention_tpu.ops.layer_norm`
(Pallas kernel in interpret mode on the CPU) and
`xhy_flash_attention_tpu_torch.ops.layer_norm` (its plain version on CPU
tensors). fp32 agrees to 1e-5; bf16 outputs to one bf16 unit in the last
place of the largest value (both round one fp32 result once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops import layer_norm as jln
from xhy_flash_attention_tpu_torch.ops import layer_norm as tln

H = 256


def _inputs(dtype, has_residual, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((2, 8, H)).astype(np.float32)
    res = (rng.standard_normal((2, 8, H)) * 3).astype(np.float32) \
        if has_residual else None
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    if dtype == "bf16":
        x0 = np.array(jnp.asarray(x0, jnp.bfloat16).astype(jnp.float32))
    return x0, res, w, b


def _to_jax(a, dtype):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _to_torch(a, dtype):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.bfloat16() if dtype == "bf16" else t


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = 1e-5 if dtype == "fp32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("residual_in_fp32", [False, True])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("rms", [True, False])
def test_dropout_add_norm_matches_jax(rms, prenorm, residual_in_fp32, dtype):
    x0, res, w, b = _inputs(dtype, has_residual=True)
    jfn = jln.dropout_add_rms_norm if rms else jln.dropout_add_layer_norm
    tfn = tln.dropout_add_rms_norm if rms else tln.dropout_add_layer_norm
    bias = None if rms else b
    want = jfn(_to_jax(x0, dtype), jnp.asarray(res), jnp.asarray(w),
               None if bias is None else jnp.asarray(bias), 0.0, 1e-5,
               prenorm=prenorm, residual_in_fp32=residual_in_fp32)
    got = tfn(_to_torch(x0, dtype), torch.from_numpy(res), torch.from_numpy(w),
              None if bias is None else torch.from_numpy(bias), 0.0, 1e-5,
              prenorm=prenorm, residual_in_fp32=residual_in_fp32)
    if prenorm:
        _close(got[0], want[0], dtype)
        assert got[1].dtype == (torch.float32 if residual_in_fp32 or
                                dtype == "fp32" else torch.bfloat16)
        _close(got[1], want[1], "fp32" if residual_in_fp32 else dtype)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("rms", [True, False])
def test_norm_without_residual_matches_jax(rms):
    x0, _, w, b = _inputs("fp32", has_residual=False, seed=1)
    if rms:
        want = jln.rms_norm(jnp.asarray(x0), jnp.asarray(w), 1e-6)
        got = tln.rms_norm(torch.from_numpy(x0), torch.from_numpy(w), 1e-6)
    else:
        want = jln.layer_norm(jnp.asarray(x0), jnp.asarray(w),
                              jnp.asarray(b), 1e-6)
        got = tln.layer_norm(torch.from_numpy(x0), torch.from_numpy(w),
                             torch.from_numpy(b), 1e-6)
    _close(got, want, "fp32")


def test_cpu_tensors_take_the_plain_version():
    x0, res, w, _ = _inputs("fp32", has_residual=True)
    before = tln.ln_fwd.launches
    out, resout = tln.ln_fwd(torch.from_numpy(x0[0]), torch.from_numpy(res[0]),
                             torch.from_numpy(w), None, 1e-5, True,
                             torch.float32, True)
    ref, ref_res = tln.ln_fwd_ref(torch.from_numpy(x0[0]),
                                  torch.from_numpy(res[0]),
                                  torch.from_numpy(w), None, 1e-5, True,
                                  torch.float32, True)
    assert torch.equal(out, ref) and torch.equal(resout, ref_res)
    assert tln.ln_fwd.launches == before


@pytest.mark.parametrize("kw", [dict(dropout_p=0.1),
                                dict(rowscale=torch.ones(2, 8)),
                                dict(layerscale=torch.ones(H))])
def test_training_options_raise(kw):
    x0, res, w, _ = _inputs("fp32", has_residual=True)
    args = dict(dropout_p=0.0, rowscale=None, layerscale=None)
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tln.dropout_add_rms_norm(
            torch.from_numpy(x0), torch.from_numpy(res), torch.from_numpy(w),
            None, args["dropout_p"], 1e-5, rowscale=args["rowscale"],
            layerscale=args["layerscale"])
