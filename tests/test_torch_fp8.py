"""Port parity: the fp8 (e4m3) prefill forward and its quantizer.

The same numpy inputs, made from a seed, go through the JAX package (its
Pallas forward in interpret mode on the CPU) and the port (the plain
version of the kernel's e4m3 instantiation on CPU tensors). Each JAX call
is made once and shared by the checks that use it.

  * `quantize_fp8_per_head`: payload bytes and descales bit for bit
    (per head and over GQA groups, a group's largest value landing on 448),
    and the e4m3 cast itself on a grid around 448, every e4m3 value and
    their midpoints (round to nearest even, as ml_dtypes);
  * `flash_attn_fp8_func` on `tests/test_fp8_prefill.py`'s four shapes
    (each at one head dim and causal flag): the port's out and LSE, and
    the JAX package's, each held to that test's contract (the error
    against the fp32 reference on the dequantized inputs at most twice the
    bf16 reorder-ops baseline's, atol 1e-4 for out and 1e-3 for the LSE);
    the port also against fp32 at its own arithmetic's limit (e4m3
    products exact in fp32; P in f16, at most 2^-10 of the largest |v|;
    the bf16 output, half a unit, 2^-8 of the largest |out|; the LSE in
    fp32, 1e-4 of its magnitude per row), and against the JAX package
    directly, within that contract's 2x the baseline's error (the JAX
    package rounds the scaled q and P to bf16 and clamps exp at 70, so its
    own distance from fp32 is of the baseline's size: 0.7-1.1x of it on
    the LSE here; the port sits on fp32, so this is the JAX contract seen
    from the port, not the 4x that holding both to fp32 alone allows);
    a window with softcap the same way;
  * `reference.fp8_ref_errors`, the readings the card's kernel is held
    to against its plain version: 0 for the plain version against itself,
    over their limits for a descale 1% off (q, k or v);
  * descales None equal to ones, bit for bit; the autograd entry
    (`flash_attention`) with e4m3 inputs equal to the fp8 entry; the
    refusals (bias, dropout, mixed dtypes, segment ids: ``ValueError``).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu import flash_attn_fp8_func as jfp8
from xhy_flash_attention_tpu.ops.quant import \
    quantize_fp8_per_head as jquant_fp8
from xhy_flash_attention_tpu_torch import flash_attention, flash_attn_fp8_func
from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
    attention_ref
from xhy_flash_attention_tpu_torch.ops.quant import quantize_fp8_per_head

FP8 = torch.float8_e4m3fn


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spread(rng, b, s, nh, d):
    """Normal values with per-head magnitudes spanning ~30x (the JAX
    test's: uniform scales would hide descale-indexing faults)."""
    x = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    mags = 0.2 * (1.0 + np.arange(nh, dtype=np.float32) * 29.0
                  / max(nh - 1, 1))
    return x * mags[None, None, :, None]



@functools.lru_cache(maxsize=None)
def _inputs(b, sq, sk, h, hk, d, seed=0):
    """(q8, k8, v8, qd, kd, vd) of both packages from one numpy draw, each
    quantized by its own package (checked equal below)."""
    rng = np.random.default_rng(seed)
    q, k, v = (_spread(rng, b, sq, h, d), _spread(rng, b, sk, hk, d),
               _spread(rng, b, sk, hk, d))
    j = [jquant_fp8(jnp.asarray(q), hk), jquant_fp8(jnp.asarray(k)),
         jquant_fp8(jnp.asarray(v))]
    t = [quantize_fp8_per_head(torch.from_numpy(q), hk),
         quantize_fp8_per_head(torch.from_numpy(k)),
         quantize_fp8_per_head(torch.from_numpy(v))]
    return j, t


def _deq(x8, dsc, hk):
    b, s, h, d = x8.shape
    return (x8.float().reshape(b, s, hk, h // hk, d)
            * dsc[:, None, :, None, None]).reshape(b, s, h, d)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _contract(out, ref, lp, what, atol, jax_out=None):
    """``out`` within twice the baseline ``lp``'s error against ``ref``;
    with ``jax_out`` (the port's check) the JAX package's output too."""
    err_lp = _err(lp, ref)
    for name, x in ((what, out), (f"{what} vs jax", jax_out)):
        if x is not None:
            e = _err(out, ref if x is out else x)
            assert e <= 2 * err_lp + atol, \
                f"{name}: {e} > 2 x {err_lp} + {atol}"


def _lse(qx, kx, h, hk, causal):
    s = torch.einsum("bshd,bthd->bhst", qx.float(),
                     kx.float().repeat_interleave(h // hk, dim=2))
    s = s * qx.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq)[:, None]
        cols = torch.arange(sk)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), -float("inf"))
    return torch.logsumexp(s, -1)


def _check_against_ref(out, lse, t, hk, what, jax_out=None, jax_lse=None,
                       **kw):
    """out (and lse) held to the contract on the dequantized inputs; with
    the JAX package's out (and lse), also to it directly."""
    (q8, qd), (k8, kd), (v8, vd) = t
    qf, kf, vf = _deq(q8, qd, hk), _deq(k8, kd, hk), _deq(v8, vd, hk)
    ref, _ = attention_ref(qf, kf, vf, upcast=True, **kw)
    lp, _ = attention_ref(qf.bfloat16(), kf.bfloat16(), vf.bfloat16(),
                          upcast=False, reorder_ops=True, **kw)
    _contract(out, ref, lp, f"{what} out", 1e-4, jax_out)
    port = jax_out is not None
    if port:
        lim = 2 ** -8 * ref.abs().max().item() + 2 ** -10 * vf.abs().max().item()
        assert _err(out, ref) <= lim, f"{what} out: {_err(out, ref)} > {lim}"
    if lse is not None:
        causal = kw.get("causal", False)
        h = q8.shape[2]
        ref_l = _lse(qf, kf, h, hk, causal)
        _contract(lse, ref_l, _lse(qf.bfloat16(), kf.bfloat16(), h, hk, causal),
                  f"{what} lse", 1e-3, jax_lse)
        if port:
            fin = torch.isfinite(ref_l)
            assert torch.equal(fin, torch.isfinite(lse))
            assert ((lse[fin] - ref_l[fin]).abs()
                    <= 1e-4 * (1 + ref_l[fin].abs())).all(), what


# ---- the quantizer


@pytest.mark.parametrize("h,hk", [(4, 4), (8, 2), (6, 1)])
def test_quantize_fp8_per_head_bit_exact(h, hk):
    rng = np.random.default_rng(h * 10 + hk)
    x = _spread(rng, 2, 37, h, 16)
    x[0, 5, 0, 3] = 100.0  # the group's largest: lands on 448 exactly
    got, dsc = quantize_fp8_per_head(torch.from_numpy(x), hk)
    want, wdsc = jquant_fp8(jnp.asarray(x), hk)
    assert got.dtype == FP8 and tuple(dsc.shape) == (2, hk)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
    np.testing.assert_array_equal(dsc.numpy().view(np.uint32),
                                  np.asarray(wdsc).view(np.uint32))
    assert got.float().abs().max().item() == 448.0
    assert got[0, 5, 0, 3].float().item() == 448.0


def test_e4m3_cast_rounds_as_ml_dtypes():
    """Every finite e4m3 value, the midpoints between neighbours (ties to
    even), a fine grid from 440 to 464 (448 and the values that round to
    it) and the subnormals, positive and negative."""
    vals = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.sort(vals.astype(np.float32)[np.isfinite(vals.astype(
        np.float32))])
    mids = (vals[1:] + vals[:-1]) / 2
    grid = np.concatenate([vals, mids, np.linspace(440, 463.9, 240,
                                                   dtype=np.float32),
                           np.linspace(0, 2 ** -6, 97, dtype=np.float32)])
    grid = np.concatenate([grid, -grid]).astype(np.float32)
    got = torch.from_numpy(grid).to(FP8).view(torch.uint8).numpy()
    want = grid.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(got, want)


# ---- the forward against the JAX package

SHAPES = [  # b, sq, sk, h, hk, d, causal: the JAX test's four shapes,
    # each at one of its head dims and causal flags
    (2, 113, 203, 2, 2, 64, True),
    (2, 256, 256, 8, 2, 128, False),
    (2, 128, 128, 3, 3, 128, True),
    (2, 257, 257, 2, 2, 64, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_fp8_forward_contract_against_jax(shape):
    b, sq, sk, h, hk, d, causal = shape
    j, t = _inputs(b, sq, sk, h, hk, d)
    for (jx, jd), (tx, td) in zip(j, t):
        np.testing.assert_array_equal(tx.view(torch.uint8).numpy(),
                                      np.asarray(jx).view(np.uint8))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    out, lse = flash_attn_fp8_func(*(x for x, _ in t), *(s for _, s in t),
                                   causal=causal, return_lse=True)
    assert out.dtype == torch.bfloat16 and out.shape == (b, sq, h, d)
    assert lse.shape == (b, h, sq)
    jout, jlse = jfp8(*(x for x, _ in j), *(s for _, s in j), causal=causal,
                      return_lse=True)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse))
    _check_against_ref(jout, jlse, t, hk, "jax", causal=causal)
    _check_against_ref(out, lse, t, hk, "port", jout, jlse, causal=causal)


def test_fp8_window_softcap_against_jax():
    """A window (64, 0) and softcap 30 in one call (one JAX call)."""
    kw = dict(window_size=(64, 0), softcap=30.0)
    b, s, h, d = 1, 200, 2, 64
    j, t = _inputs(b, s, s, h, h, d, seed=5)
    out = flash_attn_fp8_func(*(x for x, _ in t), *(s_ for _, s_ in t), **kw)
    jout = jfp8(*(x for x, _ in j), *(s_ for _, s_ in j), **kw)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    _check_against_ref(jout, None, t, h, f"jax {kw}", **kw)
    _check_against_ref(out, None, t, h, f"port {kw}", jout, **kw)


@pytest.mark.parametrize("fault", ["q", "k", "v"])
def test_fp8_ref_errors_flag_a_descale_fault(fault):
    """The readings the card's kernel is held to (reference.fp8_ref_errors)
    are 0 for the plain version against itself and over their limits for
    one whose descale of `fault` is 1% off."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import reference
    _, t = _inputs(2, 200, 200, 8, 2, 64, seed=11)
    (q8, qd), (k8, kd), (v8, vd) = t
    sc = 64 ** -0.5

    def run(**off):
        ds = {"q": qd, "k": kd, "v": vd}
        ds = [ds[n] * off.get(n, 1.0) for n in "qkv"]
        o, lse = reference.attention_fp8_ref(
            q8.transpose(1, 2), k8.transpose(1, 2), v8.transpose(1, 2), *ds,
            sm_scale=sc, causal=True)
        return o.transpose(1, 2), lse
    ref, ref_lse = run()
    errs = lambda o, l: reference.fp8_ref_errors(  # noqa: E731
        o, l, ref, ref_lse, q8, k8, qd, kd, vd, sc)
    eo, el = errs(ref, ref_lse)
    assert eo <= 0 and el <= 0
    eo, el = errs(*run(**{fault: 1.01}))
    assert (eo > reference.FP8_OUT_TOL if fault == "v"
            else el > reference.FP8_LSE_TOL), (fault, eo, el)


def test_fp8_default_descale_is_identity():
    rng = np.random.default_rng(7)
    q8, k8, v8 = (torch.from_numpy(rng.standard_normal(
        (1, 128, 2, 64)).astype(np.float32)).to(FP8) for _ in range(3))
    ones = torch.ones(1, 2)
    a, la = flash_attn_fp8_func(q8, k8, v8, causal=True, return_lse=True)
    b, lb = flash_attn_fp8_func(q8, k8, v8, ones, ones, ones, causal=True,
                                return_lse=True)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_fp8_through_the_autograd_entry():
    """`flash_attention` ((b, h, s, d) layout) routes e4m3 inputs to the
    same forward, window included."""
    _, t = _inputs(1, 96, 96, 4, 2, 64, seed=3)
    (q8, qd), (k8, kd), (v8, vd) = t
    want = flash_attn_fp8_func(q8, k8, v8, causal=True, window_size=(40, -1))
    got = flash_attention(q8.transpose(1, 2), k8.transpose(1, 2),
                          v8.transpose(1, 2), causal=True,
                          window_size=(40, -1))
    assert torch.equal(got.transpose(1, 2), want)


@pytest.mark.parametrize("what", ["bias", "dropout", "mixed", "segments"])
def test_fp8_refusals(what):
    x = torch.zeros(1, 2, 128, 64).to(FP8)
    seg = torch.zeros(1, 128, dtype=torch.int32)
    calls = {
        "bias": lambda: flash_attention(x, x, x, torch.zeros(1, 2, 128, 128)),
        "dropout": lambda: flash_attention(x, x, x, dropout_p=0.1,
                                           dropout_seed=0),
        "mixed": lambda: flash_attention(x, x.bfloat16(), x),
        "segments": lambda: flash_attention(x, x, x, None, seg, seg),
    }
    with pytest.raises(ValueError):
        calls[what]()
