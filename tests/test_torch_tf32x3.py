"""The fp32 attention kernels' arithmetic on the CPU. csrc/flash_fp32.cu's
forward and its dK/dV and dQ kernels compute every product as three TF32
products on the tensor cores, which read a .tf32 operand with its low 13
bits dropped: hi = tf32(x), lo = tf32(x - hi), lo·hi + hi·lo + hi·hi summed
in fp32. reference.py emulates the split (``split_tf32``), and the forward
and the backward with every product through ``matmul_tf32x3``
(``attention_fwd_tf32x3``, ``attention_bwd_tf32x3``). The same numpy inputs
go through the emulation, the port's fp32 plain version, the JAX package's
fp32 forward and backward (``jax.vjp``, Pallas in interpret mode) and
float64: out and LSE, or dq, dk and dv, of the emulation meet the fp32
contract against float64 (error at most twice the fp32 plain version's,
plus 1e-4), are as close to float64 as JAX's fp32 results under the same
contract, and lie within 5e-5 of JAX's relative to each result's largest
entry (fp32 sums in another order). Small shapes: head dims 64 and 128, GQA
4 over 1, causal, a window and softcap 30, lengths not a multiple of 64.
And why three products: with one TF32 product the backward's error against
float64 is at least ten times larger.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd as tbwd
from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd as tfwd
from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import (
    attention_bwd_tf32x3,
    attention_fwd_tf32x3,
    construct_local_mask,
    matmul_tf32x3,
    split_tf32,
    tf32_trunc,
)

B, H, HK = 2, 4, 1
# d, sq, sk, causal, window, softcap
CASES = [
    (64, 113, 203, True, (-1, -1), 0.0),
    (128, 130, 130, True, (-1, -1), 30.0),
    (64, 150, 150, False, (40, 10), 0.0),
    (128, 77, 140, False, (-1, -1), 30.0),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when the
    suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bits(x):
    return struct.unpack("<I", struct.pack("<f", x))[0]


def test_split_is_what_the_tensor_cores_read():
    """The H100's tensor cores ignore a .tf32 operand's low 13 bits
    (scripts/tf32_probe.cu): hi is the truncated value, either sign; lo =
    x - hi is exact and truncated in turn; both are TF32 values; inf and
    nan stay in hi, lo nan."""
    x = torch.tensor([_f32(v) for v in (0x3F801FFF, 0xBF801FFF, 0x3F812345)]
                     + [float("inf"), float("-inf"), float("nan")])
    hi, lo = split_tf32(x)
    assert [_bits(v) for v in hi.tolist()[:3]] == [
        0x3F800000, 0xBF800000, 0x3F812000]
    # 0x3f812345 - 0x3f812000 = 0x345 ulps of 2^-23: 0x345 p-23 exactly, of
    # which tf32 keeps the leading 11 bits (0x345 has 10)
    assert lo[2].item() == 0x345 * 2.0 ** -23
    assert lo[0].item() == -lo[1].item() == (0x1FFF & ~0x3) * 2.0 ** -23
    assert hi[3].item() == float("inf") and hi[4].item() == float("-inf")
    assert torch.isnan(hi[5]) and torch.isnan(lo[3:]).all()
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    h, lo = split_tf32(y)
    for part in (h, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
        assert torch.equal(tf32_trunc(part), part)
    assert ((h.double() + lo.double() - y.double()).abs()
            <= 2.0 ** -21 * y.double().abs()).all()


def _keep(sq, sk, causal, window):
    left, right = window
    return ~construct_local_mask(sq, sk, (left, 0 if causal else right))


def _attention64(q, k, v, sm_scale, softcap, keep):
    """(out, lse) in float64; rows that see no key give 0 and lse -inf."""
    g = q.shape[1] // k.shape[1]
    s = (q.double() * sm_scale) @ k.double().repeat_interleave(
        g, 1).transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, -1))
    return p @ v.double().repeat_interleave(g, 1), torch.logsumexp(s, -1)


def _attention64_grads(q, k, v, do, sm_scale, softcap, keep):
    ins = [t.double().requires_grad_() for t in (q, k, v)]
    out, _ = _attention64(*ins, sm_scale, softcap, keep)
    return torch.autograd.grad(out, ins, do.double())


def _case(d, sq, sk, causal, window, softcap, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, sq, d), (B, HK, sk, d), (B, HK, sk, d), (B, H, sq, d))]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    keep = _keep(sq, sk, causal, window)
    kw = dict(sm_scale=d ** -0.5, softcap=softcap)
    out, lse = tfwd.attention_fwd_ref(q, k, v, need_lse=True, causal=False,
                                      mask=keep[None, None], **kw)
    return arrays, (q, k, v, do, out, lse), keep, kw


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("d,sq,sk,causal,window,softcap", CASES)
def test_tf32x3_backward_meets_the_fp32_contract(d, sq, sk, causal, window,
                                                 softcap):
    arrays, (q, k, v, do, out, lse), keep, kw = _case(
        d, sq, sk, causal, window, softcap, seed=d + sq + sk)
    mask = keep[None, None]
    emul = attention_bwd_tf32x3(q, k, v, out, lse, do, mask=mask, **kw)
    plain = tbwd.attention_bwd_ref(q, k, v, out, lse, do, causal=False,
                                   mask=mask, **kw)
    want = _attention64_grads(q, k, v, do, kw["sm_scale"], softcap, keep)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jflash_attention(
            q_, k_, v_, causal=causal, window_size=window, softcap=softcap),
        *map(jnp.asarray, arrays[:3]))
    jgrads = [torch.from_numpy(np.array(g, np.float32))
              for g in vjp(jnp.asarray(arrays[3]))]
    for name, e, p, j, w in zip(("dq", "dk", "dv"), emul, plain, jgrads,
                                want):
        assert e.dtype == torch.float32 and e.shape == w.shape
        err, err_plain, err_jax = _err(e, w), _err(p, w), _err(j, w)
        assert err <= 2 * err_plain + 1e-4, (name, err, err_plain)
        assert err <= 2 * err_jax + 1e-4, (name, err, err_jax)
        assert _err(e, j) <= 5e-5 * j.abs().max().item(), (name, _err(e, j))


@pytest.mark.parametrize("d,sq,sk,causal,window,softcap", CASES)
def test_tf32x3_forward_meets_the_fp32_contract(d, sq, sk, causal, window,
                                                softcap):
    """The forward's emulation: out and the LSE (on the rows that see a
    key) under the contract against float64, beside the fp32 plain
    forward and JAX's fp32 forward, and within 5e-5 of JAX's."""
    arrays, (q, k, v, _, out, lse), keep, kw = _case(
        d, sq, sk, causal, window, softcap, seed=d + sq + sk)
    emul = attention_fwd_tf32x3(q, k, v, mask=keep[None, None], **kw)
    want = _attention64(q, k, v, kw["sm_scale"], softcap, keep)
    jout, jlse = jflash_attention(
        *map(jnp.asarray, arrays[:3]), causal=causal, window_size=window,
        softcap=softcap, return_lse=True)
    jax_res = [torch.from_numpy(np.array(x, np.float32)) for x in (jout, jlse)]
    seen = torch.isfinite(want[1])
    assert seen.any() and torch.equal(torch.isfinite(emul[1]), seen)
    for name, e, p, j, w in zip(("out", "lse"), emul, (out, lse), jax_res,
                                want):
        assert e.dtype == torch.float32 and e.shape == w.shape
        if name == "lse":
            e, p, j, w = e[seen], p[seen], j[seen], w[seen]
        err, err_plain, err_jax = _err(e, w), _err(p, w), _err(j, w)
        assert err <= 2 * err_plain + 1e-4, (name, err, err_plain)
        assert err <= 2 * err_jax + 1e-4, (name, err, err_jax)
        assert _err(e, j) <= 5e-5 * j.abs().max().item(), (name, _err(e, j))


def test_one_tf32_product_is_not_enough():
    """With one seed: the backward with single TF32 products lands at least
    ten times farther from float64 than with three, in each gradient."""
    d, sq, sk, causal, window, softcap = CASES[0]
    _, (q, k, v, do, out, lse), keep, kw = _case(d, sq, sk, causal, window,
                                                 softcap, seed=0)
    mask = keep[None, None]
    want = _attention64_grads(q, k, v, do, kw["sm_scale"], softcap, keep)
    three = attention_bwd_tf32x3(q, k, v, out, lse, do, mask=mask, **kw)
    one = attention_bwd_tf32x3(
        q, k, v, out, lse, do, mask=mask,
        matmul=lambda a, b: tf32_trunc(a) @ tf32_trunc(b), **kw)
    for name, t3, t1, w in zip(("dq", "dk", "dv"), three, one, want):
        e3, e1 = _err(t3, w), _err(t1, w)
        assert e1 >= 10 * e3, (name, e1, e3)


def test_matmul_tf32x3_is_fp32_accurate():
    """Three TF32 products of random 96 x 80 by 80 x 72 matrices: within
    twice the fp32 product's error against float64 (plus 1e-6), where one
    TF32 product is a hundred times farther."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((96, 80)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((80, 72)).astype(np.float32))
    want = a.double() @ b.double()
    e3, e32 = _err(matmul_tf32x3(a, b), want), _err(a @ b, want)
    e1 = _err(tf32_trunc(a) @ tf32_trunc(b), want)
    assert e3 <= 2 * e32 + 1e-6, (e3, e32)
    assert e1 >= 100 * e3, (e1, e3)
