"""Port parity: attention bias with its gradient, and the C-API bridge.

The same numpy inputs, made from a seed, go through the JAX package (Pallas
kernels in interpret mode on the CPU) and the port (the plain versions on
CPU tensors). Each JAX call is made once and shared by the cases that use
its inputs.

  * `flash_attention(q, k, v, bias)` and its gradients (torch.autograd
    against jax.vjp) for every bias shape, (sq, sk), (b, sq, sk), (1, h,
    sq, sk), (b, 1, sq, sk), (b, h, sq, sk), causal with GQA (a
    head-broadcast bias's dbias summed over the group), with softcap and a
    window, with segment ids and positions, and with a bias-only gradient:
    fp32 within 1e-5 (out) and 5e-5 (gradients) of the largest JAX entry; a
    bf16 bias's dbias within one bf16 unit of its largest entry;
  * `capi_bridge`'s five functions against the JAX package's bridge on the
    same inputs, bf16 crossing as raw uint16: bf16 outputs within two bf16
    units of the largest JAX entry (out, lse: 1e-3 absolute), bf16
    gradients within four (the two round P and dS to bf16 in sums of another
    order), fp32 dbias and reduced scores within 1e-3 of the largest entry;
    and the same ValueErrors;
  * `attn_fwd` / `attn_bwd` on float32 numpy inputs with an attn_mask (b, 1,
    s, s), causal with GQA (the fp32 kernels' BIAS instantiations and the
    fp32 dbias kernel on the card): out within 1e-5 and the LSE within 1e-5
    of the largest JAX entry, dq/dk/dv and dbias within 5e-5 (fp32 in sums
    of another order, as above), dbias fp32 in the mask's broadcast shape.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu import capi_bridge as jcapi
from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
)
from xhy_flash_attention_tpu_torch import capi_bridge as tcapi
from xhy_flash_attention_tpu_torch.ops.flash_attention import flash_attention
from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd as tbwd

B, H, HK, D = 2, 4, 2, 64
S = 97  # odd: the TPU kernels pad to their blocks
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, abs_=0.0):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30) + abs_)


BIAS_SHAPES = {"2d": (S, S), "3d": (B, S, S), "1h": (1, H, S, S),
               "b1": (B, 1, S, S), "bh": (B, H, S, S)}
CASES = {
    # name: (bias kind, bias dtype, flash_attention keywords)
    **{kind: (kind, np.float32, dict(causal=True)) for kind in BIAS_SHAPES},
    "bf16": ("1h", ml_dtypes.bfloat16, dict(causal=True)),
    "softcap_window": ("b1", np.float32,
                       dict(causal=True, softcap=5.0, window_size=(40, -1))),
    "segments_positions": ("bh", np.float32, dict(tokens=True)),
}


def _inputs(name):
    kind, dtype, kw = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = [_randn(rng, (B, H, S, D)), _randn(rng, (B, HK, S, D)),
              _randn(rng, (B, HK, S, D)),
              _randn(rng, BIAS_SHAPES[kind], 2.0).astype(dtype)]
    do = _randn(rng, (B, H, S, D))
    kw = dict(kw)
    if kw.pop("tokens", False):
        seg = np.sort(rng.integers(0, 3, (B, S)), -1).astype(np.int32)
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        kw.update(q_segment_ids=seg, kv_segment_ids=seg, q_positions=pos,
                  kv_positions=pos)
    return arrays, do, kw


def _split(kw, to):
    """(segment ids as positional arguments, keywords) in ``to``'s arrays."""
    seg = tuple(to(kw.pop(n)) if n in kw else None
                for n in ("q_segment_ids", "kv_segment_ids"))
    for n in ("q_positions", "kv_positions"):
        if n in kw:
            kw[n] = to(kw[n])
    return seg, kw


@functools.lru_cache(maxsize=None)
def _jax(name):
    """out and (dq, dk, dv, dbias) of the JAX package for case ``name``."""
    arrays, do, kw = _inputs(name)
    seg, kw = _split(kw, jnp.asarray)

    def f(q, k, v, bias):
        return jflash_attention(q, k, v, bias, *seg, **kw)
    out, vjp = jax.vjp(f, *map(jnp.asarray, arrays))
    return out, vjp(jnp.asarray(do))


def _port(name, wrt=(0, 1, 2, 3)):
    arrays, do, kw = _inputs(name)
    seg, kw = _split(kw, torch.from_numpy)
    ins = [torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
        torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(a) for a in arrays]
    for i in wrt:
        ins[i].requires_grad_()
    out = flash_attention(*ins, *seg, **kw)
    grads = torch.autograd.grad(out, [ins[i] for i in wrt],
                                torch.from_numpy(do))
    return out, grads


@pytest.mark.parametrize("name", list(CASES))
def test_bias_matches_jax(name):
    """out, dq, dk, dv and dbias of the port against the JAX package; dbias
    in the bias's shape and dtype."""
    want_out, want = _jax(name)
    got_out, got = _port(name)
    _close(got_out, want_out, 1e-5)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 5e-5)
    bias_dtype = CASES[name][1]
    assert tuple(got[3].shape) == BIAS_SHAPES[CASES[name][0]]
    if bias_dtype == ml_dtypes.bfloat16:
        assert got[3].dtype == torch.bfloat16
        _close(got[3], want[3], BF16_ULP)
    else:
        assert got[3].dtype == torch.float32
        _close(got[3], want[3], 5e-5)


def test_bias_only_gradient():
    """With q, k and v not needing a gradient the call still goes through
    the autograd function; dbias as with every input (case "b1")."""
    _, want = _jax("b1")
    out, (dbias,) = _port("b1", wrt=(3,))
    assert out.grad_fn is not None
    _close(dbias, want[3], 5e-5)


def test_bias_plain_backward_reduces_broadcast_axes():
    """flash_attention_bwd on the CPU returns dbias in the bias's own shape
    (2-D here), the sum of the per-head (b, h, sq, sk) one."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_randn(rng, (B, h, 33, D)))
               for h in (H, HK, HK))
    bias = torch.from_numpy(_randn(rng, (33, 33)))
    do = torch.from_numpy(_randn(rng, (B, H, 33, D)))
    kw = dict(sm_scale=D ** -0.5, causal=True)
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    out, lse = fwd.flash_attention_fwd(q, k, v, bias, **kw)
    *_, db = tbwd.flash_attention_bwd(q, k, v, out, lse, do, bias, **kw)
    *_, db_full = tbwd.flash_attention_bwd(
        q, k, v, out, lse, do, bias.expand(B, H, 33, 33).contiguous(), **kw)
    assert db.shape == (33, 33)
    torch.testing.assert_close(db, db_full.sum((0, 1)), rtol=1e-5, atol=1e-5)
    grads = tbwd.flash_attention_bwd(q, k, v, out, lse, do, bias,
                                     need_dqkv=False, **kw)
    assert grads[:3] == (None,) * 3 and torch.equal(grads[3], db)


@pytest.mark.parametrize("bias", [
    torch.zeros(3, 4, 8, 8),     # bias batch not 1 or b
    torch.zeros(1, 3, 8, 8),     # bias heads not 1 or h
    torch.zeros(8, 9),           # not (sq, sk)
    torch.zeros(8, 8, dtype=torch.float16),
])
def test_bias_shapes_refused(bias):
    q = torch.randn(2, 4, 8, 64)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, bias)


def test_fp8_with_bias_raises():
    q = torch.randn(1, 2, 8, 64).to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, torch.zeros(8, 8))


# ---- the C-API bridge

def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _raw(a):
    """A bf16 array as the C ABI carries it: raw uint16 words."""
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@functools.lru_cache(maxsize=None)
def _bridge_inputs():
    rng = np.random.default_rng(13)
    b, s, h, hk, d = 2, 80, 4, 2, 64
    q, do = (_bf16(_randn(rng, (b, s, h, d))) for _ in range(2))
    k, v = (_bf16(_randn(rng, (b, s, hk, d))) for _ in range(2))
    bias = _randn(rng, (1, h, s, s), 2.0)
    fm = np.sort(rng.integers(s // 2, s + 1, (b, 1, s, 1)), 2).astype(np.int32)
    return q, k, v, do, bias, fm


@functools.lru_cache(maxsize=None)
def _jax_bridge(which):
    q, k, v, do, bias, fm = _bridge_inputs()
    if which == "fwd_bias":
        return jcapi.attn_fwd(q, k, v, bias, None, 0.0, 0, 0.0, 1, 30, -1,
                              5.0)
    if which == "fwd_fm":
        return jcapi.attn_fwd(q, k, v, None, fm, 0.0, 0, 0.0, 1, -1, -1, 0.0)
    if which == "bwd_bias":
        out, lse = _jax_bridge("fwd_bias")
        return jcapi.attn_bwd(do, q, k, v, out, lse, bias, None, 0.0, 0, 0.0,
                              1, 30, -1, 5.0)
    if which == "bwd_fm":
        out, lse = _jax_bridge("fwd_fm")
        return jcapi.attn_bwd(do, q, k, v, out, lse, None, fm, 0.0, 0, 0.0,
                              1, -1, -1, 0.0)
    if which == "fwd_drop":
        return jcapi.attn_fwd(q, k, v, None, None, 0.1, 7, 0.0, 1, -1, -1,
                              0.0)
    if which == "bwd_drop":
        out, lse = _jax_bridge("fwd_drop")
        return jcapi.attn_bwd(do, q, k, v, out, lse, None, None, 0.1, 7, 0.0,
                              1, -1, -1, 0.0)
    raise KeyError(which)


def _port_bridge(which):
    q, k, v, do, bias, fm = (_raw(a) for a in _bridge_inputs())
    if which == "fwd_bias":
        return tcapi.attn_fwd(q, k, v, bias, None, 0.0, 0, 0.0, 1, 30, -1,
                              5.0, device="cpu")
    if which == "fwd_fm":
        return tcapi.attn_fwd(q, k, v, None, fm, 0.0, 0, 0.0, 1, -1, -1, 0.0,
                              device="cpu")
    if which == "fwd_drop":
        return tcapi.attn_fwd(q, k, v, None, None, 0.1, 7, 0.0, 1, -1, -1,
                              0.0, device="cpu")
    out, lse = (_raw(a) for a in _jax_bridge(which.replace("bwd", "fwd")))
    if which == "bwd_drop":
        return tcapi.attn_bwd(do, q, k, v, out, lse, None, None, 0.1, 7, 0.0,
                              1, -1, -1, 0.0, device="cpu")
    if which == "bwd_bias":
        return tcapi.attn_bwd(do, q, k, v, out, lse, bias, None, 0.0, 0, 0.0,
                              1, 30, -1, 5.0, device="cpu")
    return tcapi.attn_bwd(do, q, k, v, out, lse, None, fm, 0.0, 0, 0.0, 1,
                          -1, -1, 0.0, device="cpu")


@functools.lru_cache(maxsize=None)
def _bridge_f32():
    """float32 (b, s, h, d) inputs with a (b, 1, s, s) attn_mask, as the
    reference C API takes PaddlePaddle's, and the JAX bridge's forward and
    backward on them (causal, GQA 2)."""
    rng = np.random.default_rng(23)
    b, s, h, hk, d = 2, 72, 4, 2, 64
    q, do = (_randn(rng, (b, s, h, d)) for _ in range(2))
    k, v = (_randn(rng, (b, s, hk, d)) for _ in range(2))
    mask = _randn(rng, (b, 1, s, s), 2.0)
    out, lse = jcapi.attn_fwd(q, k, v, mask, None, 0.0, 0, 0.0, 1, -1, -1,
                              0.0)
    grads = jcapi.attn_bwd(do, q, k, v, out, lse, mask, None, 0.0, 0, 0.0, 1,
                           -1, -1, 0.0)
    return (q, k, v, do, mask), (out, lse), grads


def test_bridge_fp32_attn_mask_matches_jax():
    """attn_fwd and attn_bwd on float32 arrays with an attn_mask: fp32
    out, LSE and gradients, dbias (b, 1, s, s) fp32, against the JAX
    bridge on the same inputs (the backward from the JAX forward's out and
    lse, handed to both)."""
    (q, k, v, do, mask), (want_out, want_lse), want = _bridge_f32()
    out, lse = tcapi.attn_fwd(q, k, v, mask, None, 0.0, 0, 0.0, 1, -1, -1,
                              0.0, device="cpu")
    assert out.dtype == np.float32 and out.shape == want_out.shape
    _close(out, want_out, 1e-5)
    _close(lse, want_lse, 1e-5)
    got = tcapi.attn_bwd(do, q, k, v, want_out, want_lse, mask, None, 0.0, 0,
                         0.0, 1, -1, -1, 0.0, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.float32
        _close(g, w, 5e-5)
    assert got[3].dtype == np.float32 and got[3].shape == mask.shape
    _close(got[3], want[3], 5e-5)


@pytest.mark.parametrize("which", ["fwd_bias", "fwd_fm"])
def test_bridge_attn_fwd_matches_jax(which):
    got_out, got_lse = _port_bridge(which)
    want_out, want_lse = _jax_bridge(which)
    assert got_out.dtype == tcapi.np_dtype("bfloat16")
    assert got_out.shape == want_out.shape and got_lse.dtype == np.float32
    _close(got_out, want_out, 2 * BF16_ULP, 1e-3)
    _close(got_lse, want_lse, 0.0, 1e-3)


@pytest.mark.parametrize("which", ["bwd_bias", "bwd_fm"])
def test_bridge_attn_bwd_matches_jax(which):
    """The backward from the forward's saved out and lse (the JAX bridge's,
    handed to both): dq, dk, dv and, with the bias, dbias fp32 in its
    broadcast shape."""
    got = _port_bridge(which)
    want = _jax_bridge(which)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == tcapi.np_dtype("bfloat16")
        _close(g, w, 4 * BF16_ULP, 1e-4)
    if which == "bwd_bias":
        assert got[3].dtype == np.float32 and got[3].shape == (1, 4, 80, 80)
        _close(got[3], want[3], 1e-3)
    else:
        assert got[3] is None and want[3] is None


def test_bridge_varlen_matches_jax():
    """varlen_fwd and varlen_bwd over three documents of a packed batch,
    causal with a window."""
    rng = np.random.default_rng(17)
    total, h, hk, d = 150, 4, 2, 64
    q, do = (_bf16(_randn(rng, (total, h, d))) for _ in range(2))
    k, v = (_bf16(_randn(rng, (total, hk, d))) for _ in range(2))
    cu = np.array([0, 37, 100, 150], np.int32)
    args = (cu, cu, 0.0, 0, 0.0, 1, 20, -1, 0.0)
    want_out, want_lse = jcapi.varlen_fwd(q, k, v, *args)
    got_out, got_lse = tcapi.varlen_fwd(_raw(q), _raw(k), _raw(v), *args,
                                        device="cpu")
    _close(got_out, want_out, 2 * BF16_ULP, 1e-3)
    _close(got_lse, want_lse, 0.0, 1e-3)
    want = jcapi.varlen_bwd(do, q, k, v, *args)
    got = tcapi.varlen_bwd(*(_raw(a) for a in (do, q, k, v)), *args,
                           device="cpu")
    for g, w in zip(got, want):
        _close(g, w, 4 * BF16_ULP, 1e-4)


@pytest.mark.parametrize("given_lse", [False, True])
def test_bridge_reduced_scores_matches_jax(given_lse):
    q, k, _, _, _, _ = _bridge_inputs()
    lse = _jax_bridge("fwd_fm")[1] if given_lse else None
    want = jcapi.reduced_scores(q, k, lse, 1, 0.0)
    got = tcapi.reduced_scores(_raw(q), _raw(k), lse, 1, 0.0, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want, 1e-3)


@pytest.mark.parametrize("fn,args", [
    ("attn_fwd", dict(bias=True, fm=True)),
    ("attn_bwd", dict(bias=True, fm=True)),
    ("attn_fwd", dict(fm=True, softcap=5.0)),
    ("attn_fwd", dict(fm=True, window_left=8)),
    ("attn_fwd", dict(fm=True, p_dropout=0.1)),
])
def test_bridge_value_errors_match_jax(fn, args):
    """The ValueErrors of the JAX bridge, raised before any work."""
    q, k, v, do, bias, fm = _bridge_inputs()
    bias = bias if args.get("bias") else None
    fm = fm if args.get("fm") else None
    tail = (args.get("p_dropout", 0.0), 0, 0.0, 1,
            args.get("window_left", -1), -1, args.get("softcap", 0.0))
    lse = np.zeros((2, 4, 80), np.float32)
    for mod, conv in ((jcapi, lambda a: a), (tcapi, _raw)):
        with pytest.raises(ValueError):
            if fn == "attn_fwd":
                mod.attn_fwd(conv(q), conv(k), conv(v), bias, fm, *tail)
            else:
                mod.attn_bwd(conv(do), conv(q), conv(k), conv(v), conv(q),
                             lse, bias, fm, *tail)


def test_bridge_dropout_refused_and_dtypes():
    """Dropout, once refused here, runs as in the JAX bridge: attn_fwd and
    attn_bwd with p_dropout 0.1 and a seed (causal, GQA 2, bf16) against
    the JAX bridge's, the backward from its forward's saved out and lse;
    np_dtype gives numpy's bf16 where ml_dtypes imports (here) and
    float32."""
    got_out, got_lse = _port_bridge("fwd_drop")
    want_out, want_lse = _jax_bridge("fwd_drop")
    assert got_out.dtype == tcapi.np_dtype("bfloat16")
    _close(got_out, want_out, 2 * BF16_ULP, 1e-3)
    _close(got_lse, want_lse, 0.0, 1e-3)
    got, want = _port_bridge("bwd_drop"), _jax_bridge("bwd_drop")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == tcapi.np_dtype("bfloat16")
        _close(g, w, 4 * BF16_ULP, 1e-4)
    assert got[3] is None and want[3] is None
    assert tcapi.np_dtype("bfloat16") == ml_dtypes.bfloat16
    assert tcapi.np_dtype("float32") == np.float32
