"""Port parity: the fused residual-add norm against the JAX package.

The same numpy inputs go through `xhy_flash_attention_tpu.ops.layer_norm`
(Pallas kernel in interpret mode on the CPU) and
`xhy_flash_attention_tpu_torch.ops.layer_norm` (its plain version on CPU
tensors). fp32 agrees to 1e-5; bf16 outputs to one bf16 unit in the last
place of the largest value (both round one fp32 result once). With
dropout, rowscale and layerscale the keep mask is equal bit for bit.
"""

import jax
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
                                dict(rowscale=torch.ones(2, 7)),
                                dict(layerscale=torch.ones(H + 1))])
def test_training_options_raise(kw):
    """What the fused norm still refuses: dropout without a seed (the JAX
    package's ValueError), and a rowscale or layerscale that does not match
    x0's rows or hidden size."""
    x0, res, w, _ = _inputs("fp32", has_residual=True)
    args = dict(dropout_p=0.0, rowscale=None, layerscale=None)
    args.update(kw)
    match = "requires a seed" if "dropout_p" in kw else "does not match"
    with pytest.raises(ValueError, match=match):
        tln.dropout_add_rms_norm(
            torch.from_numpy(x0), torch.from_numpy(res), torch.from_numpy(w),
            None, args["dropout_p"], 1e-5, rowscale=args["rowscale"],
            layerscale=args["layerscale"])


# --------------------------------------------- dropout, rowscale, layerscale

SEED = 1234567


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _scale_close(got, want, dtype, what):
    """fp32: within 1e-5 of the output's scale; bf16: within 2 bf16 units
    in the last place of it."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-30)
    atol = (1e-5 * scale if dtype == "fp32"
            else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _grad_close(got, want, dtype, what, kind):
    """tests/ops/test_layer_norm.py's tolerances: fp32 1e-5 (x 4 for the
    inputs' gradients, x 20 for the parameters'), bf16 5e-2 (the same
    factors); dlayerscale 1e-3 in fp32 (its test_colscale_rowscale)."""
    base = 1e-5 if dtype == "fp32" else 5e-2
    atol = {"input": 4 * base, "param": 20 * base,
            "layerscale": 1e-3 if dtype == "fp32" else 20 * base}[kind]
    np.testing.assert_allclose(
        got.detach().float().numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), rtol=1e-5, atol=atol,
        err_msg=what)


# (rms, dtype, dropout_p, rowscale, layerscale, prenorm, residual_in_fp32,
#  residual, rows, hidden): p in {0, 0.17} with every option on and off
# somewhere, each in fp32 and bf16, LayerNorm and RMSNorm
SWEEP = [
    (False, "fp32", 0.17, True, True, True, True, True, 37, 64),
    (False, "fp32", 0.0, True, True, False, False, True, 64, 96),
    (False, "fp32", 0.17, False, False, True, False, True, 64, 64),
    (False, "bf16", 0.17, False, True, True, True, True, 37, 96),
    (False, "bf16", 0.17, True, False, False, False, True, 64, 64),
    (True, "fp32", 0.17, True, False, True, False, True, 37, 96),
    (True, "fp32", 0.17, False, True, False, False, False, 64, 64),
    (True, "bf16", 0.17, True, True, True, True, True, 64, 96),
    (True, "bf16", 0.0, False, True, True, False, True, 37, 64),
    (True, "bf16", 0.17, False, False, False, True, True, 37, 96),
]


def _sweep_id(c):
    rms, dtype, p, rs, ls, pre, r32, has_res, rows, h = c
    return "-".join([("rms" if rms else "ln"), dtype, f"p{p}",
                     "rs" if rs else "", "ls" if ls else "",
                     "pre" if pre else "post", "r32" if r32 else "",
                     "res" if has_res else "nores", f"{rows}x{h}"])


@pytest.mark.parametrize("case", SWEEP, ids=_sweep_id)
def test_training_options_match_jax(case):
    """Dropout, rowscale and layerscale against the JAX package's fused norm
    (its Pallas kernel in interpret mode): outputs and the jax.vjp
    gradients dx0, dresidual, dgamma, dbeta and dlayerscale; the keep mask
    bit for bit (the zeros of dx0 where the dropped elements are)."""
    rms, dtype, p, has_rs, has_ls, prenorm, r32, has_res, rows, h = case
    rng = np.random.default_rng(rows * h + int(p * 100))
    x0 = rng.standard_normal((rows, h)).astype(np.float32)
    if dtype == "bf16":
        x0 = _bf16_round(x0)
    res = (3 * rng.standard_normal((rows, h))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = None if rms else (0.1 * rng.standard_normal(h)).astype(np.float32)
    rs = (rng.random(rows) + 0.5).astype(np.float32) if has_rs else None
    ls = (1 + 0.2 * rng.standard_normal(h)).astype(np.float32) \
        if has_ls else None
    jfn = jln.dropout_add_rms_norm if rms else jln.dropout_add_layer_norm
    tfn = tln.dropout_add_rms_norm if rms else tln.dropout_add_layer_norm
    res_dtype = "fp32" if (r32 or dtype == "fp32") else "bf16"
    dout = rng.standard_normal((rows, h)).astype(np.float32)
    dres_in = rng.standard_normal((rows, h)).astype(np.float32)
    if dtype == "bf16":
        dout = _bf16_round(dout)
    if res_dtype == "bf16":
        dres_in = _bf16_round(dres_in)

    def jcall(x0_, res_, w_, b_, ls_):
        return jfn(x0_, res_ if has_res else None, w_, b_, p, 1e-5,
                   rowscale=None if rs is None else jnp.asarray(rs),
                   layerscale=ls_, prenorm=prenorm, residual_in_fp32=r32,
                   seed=SEED)

    jargs = (_to_jax(x0, dtype), jnp.asarray(res), jnp.asarray(w),
             None if b is None else jnp.asarray(b),
             None if ls is None else jnp.asarray(ls))
    want, vjp = jax.vjp(jcall, *jargs)
    cot = ((_to_jax(dout, dtype), _to_jax(dres_in, res_dtype)) if prenorm
           else _to_jax(dout, dtype))
    jgrads = vjp(cot)

    leaves = [_to_torch(x0, dtype).requires_grad_(),
              torch.from_numpy(res).requires_grad_(),
              torch.from_numpy(w).requires_grad_(),
              None if b is None else torch.from_numpy(b).requires_grad_(),
              None if ls is None else torch.from_numpy(ls).requires_grad_()]
    got = tfn(leaves[0], leaves[1] if has_res else None, leaves[2],
              leaves[3], p, 1e-5,
              rowscale=None if rs is None else torch.from_numpy(rs),
              layerscale=leaves[4], prenorm=prenorm, residual_in_fp32=r32,
              seed=SEED)
    outs = got if prenorm else (got,)
    wants = want if prenorm else (want,)
    _scale_close(outs[0], wants[0], dtype, "out")
    if prenorm:
        assert outs[1].dtype == (torch.float32 if res_dtype == "fp32"
                                 else torch.bfloat16)
        _scale_close(outs[1], wants[1], res_dtype, "residual_out")
    cots = [_to_torch(dout, dtype)] + (
        [_to_torch(dres_in, res_dtype)] if prenorm else [])
    used = [(i, t) for i, t in enumerate(leaves)
            if t is not None and (has_res or i != 1)]
    tgrads = torch.autograd.grad(outs, [t for _, t in used], cots)
    names = ("dx0", "dresidual", "dgamma", "dbeta", "dlayerscale")
    kinds = ("input", "input", "param", "param", "layerscale")
    for (i, _), g in zip(used, tgrads):
        _grad_close(g, jgrads[i], dtype, names[i], kinds[i])
    if p > 0:
        # dx0 is 0 exactly where an element was dropped, on both sides
        assert np.array_equal(tgrads[0].float().numpy() == 0,
                              np.asarray(jgrads[0].astype(jnp.float32)) == 0)


def test_keep_mask_matches_jax_bit_for_bit():
    """With x0 = 1, residual 0 and no scales, residual_out is the keep mask
    times 1 / (1 - p) exactly: the port's (plain version) against the JAX
    kernel's, and both against the JAX package's dropout_keep_mask; dx0's
    zeros under a random dout are the dropped elements."""
    from xhy_flash_attention_tpu.ops.flash_attention.common import \
        dropout_keep_mask as jmask
    rows, h, p = 64, 96, 0.17
    ones, zeros = np.ones((rows, h), np.float32), np.zeros((rows, h),
                                                           np.float32)
    w = np.ones(h, np.float32)
    dout = np.random.default_rng(3).standard_normal((rows, h)).astype(
        np.float32)

    def jcall(x0_):
        return jln.dropout_add_layer_norm(
            x0_, jnp.asarray(zeros), jnp.asarray(w), None, p, 1e-5,
            prenorm=True, seed=SEED)
    (jout, jres), vjp = jax.vjp(jcall, jnp.asarray(ones))
    (jdx0,) = vjp((jnp.asarray(dout), jnp.zeros_like(jres)))
    x0 = torch.from_numpy(ones).requires_grad_()
    out, resout = tln.dropout_add_layer_norm(
        x0, torch.from_numpy(zeros), torch.from_numpy(w), None, p, 1e-5,
        prenorm=True, seed=SEED)
    (dx0,) = torch.autograd.grad(out, x0, torch.from_numpy(dout))
    keep = np.asarray(jmask(jnp.int32(SEED), jnp.int32(0),
                            jnp.arange(rows, dtype=jnp.int32)[:, None],
                            jnp.arange(h, dtype=jnp.int32)[None, :], p))
    assert 0.7 < keep.mean() < 0.95
    resout = resout.detach()
    assert np.array_equal(resout.numpy() != 0, keep)
    assert np.array_equal(np.asarray(jres) != 0, keep)
    assert np.array_equal(resout.numpy(), np.asarray(jres))
    assert np.array_equal(
        tln.norm_keep_mask(SEED, p, rows, h).numpy(), keep)
    assert np.array_equal(dx0.numpy() != 0, keep)
    assert np.array_equal(np.asarray(jdx0) != 0, keep)


def test_seed_takes_its_low_32_bits():
    """A seed outside int32 keys the mask by its low 32 bits."""
    x0, res, w, _ = _inputs("fp32", has_residual=True)
    args = (torch.from_numpy(x0), torch.from_numpy(res), torch.from_numpy(w),
            None, 0.3, 1e-5)
    low = tln.dropout_add_rms_norm(*args, seed=12345)
    high = tln.dropout_add_rms_norm(*args, seed=12345 + (7 << 32))
    other = tln.dropout_add_rms_norm(*args, seed=12346)
    assert torch.equal(low, high) and not torch.equal(low, other)
