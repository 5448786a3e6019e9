"""Port parity: the parallel-residual and subset norms against the JAX
package (its fused-norm Pallas kernel in interpret mode on the CPU; the
port's plain versions on CPU tensors), as the JAX package's own
tests/ops/test_layer_norm_variants.py drives them. fp32 agrees to 1e-5 of
each output's scale, bf16 to 2 bf16 units in the last place of it; with
dropout the keep mask is the fused norm's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops import layer_norm as jln
from xhy_flash_attention_tpu_torch.ops import layer_norm as tln

SEED = 424242


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(rng, shape, dtype, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bf16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _jax(a, dtype="fp32"):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch(a, dtype="fp32"):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.bfloat16() if dtype == "bf16" else t


def _close(got, want, what):
    """Same dtype; fp32 within 1e-5 of the output's scale, bf16 within 2
    bf16 units in the last place of it."""
    bf16 = want.dtype == jnp.bfloat16
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), what
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-30)
    atol = (2 * 2.0 ** (np.floor(np.log2(scale)) - 7) if bf16
            else 1e-5 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


# (rms, dtype, has_x1, has_w1, prenorm, dropout_p, residual_in_fp32)
PARALLEL = [
    (False, "fp32", True, True, True, 0.0, False),
    (False, "fp32", True, True, True, 0.17, True),
    (True, "bf16", False, True, False, 0.17, True),
    (False, "bf16", True, False, True, 0.0, False),
    (True, "fp32", True, True, False, 0.17, False),
]


@pytest.mark.parametrize(
    "case", PARALLEL,
    ids=lambda c: "-".join([("rms" if c[0] else "ln"), c[1],
                            "x1" if c[2] else "nox1",
                            "w1" if c[3] else "now1",
                            "pre" if c[4] else "post", f"p{c[5]}",
                            "r32" if c[6] else ""]))
def test_parallel_residual_matches_jax(case):
    """dropout_add_{layer,rms}_norm_parallel_residual: x1 given or None,
    weight1 given or None, prenorm, dropout, the residual in fp32."""
    rms, dtype, has_x1, has_w1, prenorm, p, r32 = case
    rng = np.random.default_rng(7 + len(dtype) + int(p * 100))
    n, h = 64, 96
    x0, x1 = _arr(rng, (n, h), dtype), _arr(rng, (n, h), dtype)
    res = _arr(rng, (n, h), "fp32", 2.0)
    w0, w1 = (1 + 0.1 * rng.standard_normal((2, h))).astype(np.float32)
    b0, b1 = (0.1 * rng.standard_normal((2, h))).astype(np.float32)
    if rms:
        b0 = b1 = None
    if not has_w1:
        w1 = b1 = None
    if not has_x1:
        x1 = None
    jfn = (jln.dropout_add_rms_norm_parallel_residual if rms
           else jln.dropout_add_layer_norm_parallel_residual)
    tfn = (tln.dropout_add_rms_norm_parallel_residual if rms
           else tln.dropout_add_layer_norm_parallel_residual)
    common = dict(prenorm=prenorm, residual_in_fp32=r32,
                  seed=SEED if p > 0 else None)
    want = jfn(_jax(x0, dtype), _jax(x1, dtype), _jax(res), _jax(w0),
               _jax(b0), _jax(w1), _jax(b1), p, 1e-5, **common)
    got = tfn(_torch(x0, dtype), _torch(x1, dtype), _torch(res), _torch(w0),
              _torch(b0), _torch(w1), _torch(b1), p, 1e-5, **common)
    assert len(got) == len(want) == (3 if prenorm else 2)
    _close(got[0], want[0], "out0")
    if has_w1:
        _close(got[1], want[1], "out1")
    else:
        assert got[1] is None and want[1] is None
    if prenorm:
        _close(got[2], want[2], "residual_out")


def test_parallel_residual_gradients_match_jax():
    """The gradients of both outputs through the fused norm's autograd
    function against jax.vjp (dropout on, x1 given, LayerNorm)."""
    rng = np.random.default_rng(11)
    n, h, p = 37, 64, 0.17
    arrays = [_arr(rng, (n, h), "fp32") for _ in range(3)]
    params = [(1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
              for _ in range(4)]
    d0, d1 = _arr(rng, (n, h), "fp32"), _arr(rng, (n, h), "fp32")

    def jcall(x0, x1, res, w0, b0, w1, b1):
        return jln.dropout_add_layer_norm_parallel_residual(
            x0, x1, res, w0, b0, w1, b1, p, 1e-5, seed=SEED)
    inputs = [jnp.asarray(a) for a in arrays + params]
    _, vjp = jax.vjp(jcall, *inputs)
    want = vjp((jnp.asarray(d0), jnp.asarray(d1)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays + params]
    out0, out1 = tln.dropout_add_layer_norm_parallel_residual(
        *leaves, p, 1e-5, seed=SEED)
    got = torch.autograd.grad((out0, out1), leaves,
                              (torch.from_numpy(d0), torch.from_numpy(d1)))
    for i, (g, wt) in enumerate(zip(got, want)):
        # tests/ops/test_layer_norm.py's fp32 tolerances
        atol = 4e-5 if i < 3 else 2e-4
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=atol, err_msg=f"grad {i}")


# (x0_subset, out_subset, rowscale_const, out_numrows, prenorm, dropout_p)
SUBSET = [
    (True, True, 1.0, 0, False, 0.0),
    (True, True, 0.5, 5, True, 0.17),
    (False, True, 0.75, 0, True, 0.0),
]


@pytest.mark.parametrize("case", SUBSET, ids=lambda c: "-".join(
    ["in" if c[0] else "", "out" if c[1] else "", f"rs{c[2]}", f"n{c[3]}",
     "pre" if c[4] else "post", f"p{c[5]}"]))
def test_subset_matches_jax(case):
    """dropout_add_layer_norm_subset: x0's rows scattered at x0_subset,
    times rowscale_const, the out_subset rows (the first out_numrows)."""
    has_in, has_out, rsc, numrows, prenorm, p = case
    rng = np.random.default_rng(1 + numrows)
    b, s, h, m = 2, 16, 96, 7
    res = _arr(rng, (b, s, h), "fp32")
    x0 = _arr(rng, (m, h) if has_in else (b, s, h), "fp32")
    idx = np.sort(rng.choice(b * s, m, replace=False)).astype(np.int32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    kw = dict(x0_subset=idx if has_in else None,
              out_subset=idx if has_out else None, rowscale_const=rsc,
              out_numrows=numrows, prenorm=prenorm,
              seed=SEED if p > 0 else None)
    want = jln.dropout_add_layer_norm_subset(
        jnp.asarray(x0), jnp.asarray(res), jnp.asarray(w), jnp.asarray(bias),
        p, 1e-5, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()})
    got = tln.dropout_add_layer_norm_subset(
        torch.from_numpy(x0), torch.from_numpy(res), torch.from_numpy(w),
        torch.from_numpy(bias), p, 1e-5,
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    if prenorm:
        assert got[0].shape == want[0].shape
        _close(got[0], want[0], "normed")
        _close(got[1], want[1], "residual_out")
    else:
        assert got.shape == want.shape
        _close(got, want, "normed")


def test_subset_drops_layerscale_as_jax():
    """Both packages' subset norms take a layerscale and do not apply it:
    with one, the port agrees with JAX's and equals its own call without
    one bit for bit."""
    rng = np.random.default_rng(5)
    n, h, m = 32, 64, 6
    res = _arr(rng, (n, h), "fp32")
    x0 = _arr(rng, (m, h), "fp32")
    idx = np.sort(rng.choice(n, m, replace=False)).astype(np.int32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    ls = (1 + 0.3 * rng.standard_normal(h)).astype(np.float32)
    kw = dict(x0_subset=idx, out_subset=idx, rowscale_const=2.0, seed=SEED)
    want = jln.dropout_add_layer_norm_subset(
        jnp.asarray(x0), jnp.asarray(res), jnp.asarray(w), jnp.asarray(bias),
        0.17, 1e-5, layerscale=jnp.asarray(ls),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    args = [torch.from_numpy(a) for a in (x0, res, w, bias)]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tln.dropout_add_layer_norm_subset(
        *args, 0.17, 1e-5, layerscale=torch.from_numpy(ls), **tkw)
    _close(got, want, "normed")
    assert torch.equal(got, tln.dropout_add_layer_norm_subset(
        *args, 0.17, 1e-5, **tkw))
