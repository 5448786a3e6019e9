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
float64 is at least ten times larger. Under the masks of the masked fp32
kernels (a FlashMask, a block mask, segment ids with padding, q/kv
positions with segment ids; each with rows that see no key) the emulated
forward and backward meet the same contract against float64 with the
port's dense keep mask, beside the JAX package's flashmask, block-sparse
and segment / position attention; and so do the reduced scores (#12) with
the three-product q . k, beside the JAX kernel's. With an attention bias of
each kind ((sq, sk), (b, sq, sk), (1, h, sq, sk), (b, 1, sq, sk), (b, h, sq,
sk); the BIAS instantiations and the fp32 dbias kernel) the emulated forward
and backward, dbias included, meet the same contract against float64
beside the fp32 plain versions and the JAX package's fp32 flash_attention
(one jax.vjp call a kind), and dbias is the per-head one summed over the
bias's broadcast axes.
"""

import functools

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhy_flash_attention_tpu.ops.flash_attention import blocksparse as jbs
from xhy_flash_attention_tpu.ops.flash_attention import flashmask as jfm
from xhy_flash_attention_tpu.ops.flash_attention import reduced_scores as jrs
from xhy_flash_attention_tpu.ops.flash_attention.interface import (
    flash_attention as jflash_attention,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import (
    causal_document_mask,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention.reduced_scores import (
    reduced_scores_ref,
)
from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd as tbwd
from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd as tfwd
from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import (
    attention_bwd_tf32x3,
    attention_fwd_tf32x3,
    construct_local_mask,
    matmul_tf32x3,
    split_tf32,
    sum_bias_members,
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


# ---- the masked fp32 kernels' arithmetic (csrc/flash_fp32.cu, MASKED)

MASK_KINDS = ["flashmask", "block", "segments", "positions"]
MS, MG = 192, 128  # the masked cases' length; the block mask's granularity


def _mask_flags(kind, rng, n):
    """(causal, the JAX call's mask arguments, the port's flags) of mask
    ``kind``, each leaving some rows with no visible key."""
    if kind == "flashmask":  # documents, causal_1; row 0 masked out alone
        ids = np.repeat(np.arange(6), [20, 50, 31, 40, 30, 21])[None]
        lts = causal_document_mask(torch.from_numpy(
            np.repeat(ids, B, 0))).numpy().copy()
        lts[:, :, 0, 0] = 0
        return True, dict(idx=lts), dict(
            flashmask_vecs=torch.from_numpy(lts).movedim(-1, 2),
            flashmask_mode="causal_1")
    if kind == "block":  # block row 0 off: its rows see nothing
        bm = np.array([[[[0, 0], [1, 1]]]], np.int32)
        return False, dict(bm=bm), dict(
            block_mask=(torch.from_numpy(bm), MG, MG))
    seg = np.sort(rng.integers(1, 4, (B, n)), -1).astype(np.int32)
    qseg, kseg = seg.copy(), seg.copy()
    qseg[:, -30:], kseg[:, -41:] = 0, 5  # padded tails, unequal
    qseg[0, :7] = 9                      # an id no key carries
    flags = dict(q_segment_ids=qseg, kv_segment_ids=kseg)
    if kind == "positions":  # a ring shard's offsets, a left window on them
        kpos = np.tile(2 * np.arange(n, dtype=np.int32), (B, 1))
        flags.update(q_positions=kpos + 40, kv_positions=kpos)
    return True, flags, {n: torch.from_numpy(a) for n, a in flags.items()}


@functools.lru_cache(maxsize=None)
def _masked_case(kind):
    """numpy q, k, v, dO (d 64, GQA 4 over 1; the block mask's two blocks
    of MG, the others MS long); the JAX package's fp32 out,
    LSE (None for the block mask, whose entry returns none) and gradients,
    one jax.vjp call a kind; the port's keep mask of the flags, causal part
    included, (b, h, s, s)."""
    rng = np.random.default_rng(MASK_KINDS.index(kind) + 40)
    d, n = 64, 2 * MG if kind == "block" else MS
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, n, d), (B, HK, n, d), (B, HK, n, d), (B, H, n, d))]
    causal, jargs, flags = _mask_flags(kind, rng, n)
    window = (50, -1) if kind == "positions" else (-1, -1)
    if kind == "flashmask":
        fn = lambda q, k, v: jfm.flashmask_attention(  # noqa: E731
            q, k, v, jnp.asarray(jargs["idx"]), causal=True, return_lse=True)
    elif kind == "block":
        fn = lambda q, k, v: jbs.blocksparse_attention(  # noqa: E731
            q, k, v, jnp.asarray(jargs["bm"]), block_size=MG, causal=False)
    else:
        j = {n: jnp.asarray(a) for n, a in jargs.items()}
        fn = lambda q, k, v: jflash_attention(  # noqa: E731
            q, k, v, None, j["q_segment_ids"], j["kv_segment_ids"],
            causal=True, window_size=window, return_lse=True,
            q_positions=j.get("q_positions"),
            kv_positions=j.get("kv_positions"))
    res, vjp = jax.vjp(fn, *map(jnp.asarray, arrays[:3]))
    do = jnp.asarray(arrays[3])
    if kind == "block":
        jout, jlse, grads = res, None, vjp(do)
    else:
        (jout, jlse), grads = res, vjp((do, jnp.zeros_like(res[1])))
    to = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.array(x, np.float32))
    eff, masks = tfwd.build_masks(B, H, n, n, causal, window, **flags)
    keep = masks.keep(H).expand(B, H, n, n)
    if eff:
        keep = keep & torch.ones(n, n, dtype=torch.bool).tril()
    return arrays, (to(jout), to(jlse)), [to(g) for g in grads], keep


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_tf32x3_masked_forward_meets_the_fp32_contract(kind):
    """The masked forward's emulation under each mask: out and the LSE (on
    the rows that see a key; +inf and out 0 on the others, which each kind
    has) under the contract against float64, beside the fp32 plain forward
    and JAX's fp32 forward, within 5e-5 of JAX's."""
    arrays, jres, _, keep = _masked_case(kind)
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    kw = dict(sm_scale=64 ** -0.5, softcap=0.0)
    emul = attention_fwd_tf32x3(q, k, v, mask=keep, **kw)
    plain = tfwd.attention_fwd_ref(q, k, v, need_lse=True, causal=False,
                                   mask=keep, **kw)
    want = _attention64(q, k, v, kw["sm_scale"], 0.0, keep)
    seen = torch.isfinite(want[1])
    assert (~seen).any() and torch.equal(torch.isfinite(emul[1]), seen)
    assert torch.isinf(emul[1][~seen]).all() and not emul[0][~seen].any()
    for name, e, p, j, w in zip(("out", "lse"), emul, plain, jres, want):
        if j is None:  # the block-sparse entry returns no LSE
            j = p
        if name == "lse":
            e, p, j, w = e[seen], p[seen], j[seen], w[seen]
        err, err_plain, err_jax = _err(e, w), _err(p, w), _err(j, w)
        assert err <= 2 * err_plain + 1e-4, (name, err, err_plain)
        assert err <= 2 * err_jax + 1e-4, (name, err, err_jax)
        assert _err(e, j) <= 5e-5 * j.abs().max().item(), (name, _err(e, j))


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_tf32x3_masked_backward_meets_the_fp32_contract(kind):
    """The masked backward's emulation under each mask (P 0 where the mask
    hides a key, and on the rows whose LSE is +inf): dq, dk and dv under
    the contract against float64, beside the fp32 plain backward and
    JAX's, within 5e-5 of JAX's."""
    arrays, _, jgrads, keep = _masked_case(kind)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = dict(sm_scale=64 ** -0.5, softcap=0.0)
    out, lse = tfwd.attention_fwd_ref(q, k, v, need_lse=True, causal=False,
                                      mask=keep, **kw)
    emul = attention_bwd_tf32x3(q, k, v, out, lse, do, mask=keep, **kw)
    plain = tbwd.attention_bwd_ref(q, k, v, out, lse, do, causal=False,
                                   mask=keep, **kw)
    want = _attention64_grads(q, k, v, do, kw["sm_scale"], 0.0, keep)
    for name, e, p, j, w in zip(("dq", "dk", "dv"), emul, plain, jgrads,
                                want):
        assert bool(torch.isfinite(e).all()), name
        err, err_plain, err_jax = _err(e, w), _err(p, w), _err(j, w)
        assert err <= 2 * err_plain + 1e-4, (name, err, err_plain)
        assert err <= 2 * err_jax + 1e-4, (name, err, err_jax)
        assert _err(e, j) <= 5e-5 * j.abs().max().item(), (name, _err(e, j))


@pytest.mark.parametrize("d,hk,causal", [(64, 1, True), (128, 2, False)])
def test_tf32x3_reduced_scores_meet_the_fp32_contract(d, hk, causal):
    """#12 in fp32 (csrc/flash_fp32.cu reduced_scores_fp32_kernel): the sums
    of exp(sm_scale q . k - lse) with q . k as three TF32 products, on a
    causal forward's LSE with rows set to +inf, against float64 within
    twice the fp32 plain version's error + 1e-4 of the largest score (the
    sums reach tens), beside the JAX kernel's fp32 result, within 5e-5 of
    it."""
    rng = np.random.default_rng(d + hk)
    sq, sk = 96, 160
    q = rng.standard_normal((B, H, sq, d)).astype(np.float32)
    k = rng.standard_normal((B, hk, sk, d)).astype(np.float32)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = tfwd.attention_fwd_ref(qt, kt, kt, sm_scale=d ** -0.5,
                                    causal=True, softcap=0.0, need_lse=True)
    lse = lse.numpy().copy()
    lse[0, 1, :5] = np.inf
    lt = torch.from_numpy(lse)
    kr = kt.repeat_interleave(H // hk, 1).transpose(-1, -2)
    hidden = (torch.arange(sk)[None] > torch.arange(sq)[:, None] + sk - sq
              if causal else torch.zeros(sq, sk, dtype=torch.bool))

    def sums(s, lse_):
        return torch.exp(s - lse_[..., None]).masked_fill(hidden, 0.0).sum(-2)

    emul = sums(matmul_tf32x3(qt, kr) * d ** -0.5, lt)
    want = sums((qt.double() @ kr.double()) * d ** -0.5, lt.double())
    plain = reduced_scores_ref(qt, kt, lt, sm_scale=d ** -0.5, causal=causal)
    jax_res = torch.from_numpy(np.array(jrs.calc_reduced_attn_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse), causal=causal),
        np.float32))
    top = want.abs().max().item()
    assert _err(emul, want) <= 2 * _err(plain, want) + 1e-4 * top
    assert _err(emul, want) <= 2 * _err(jax_res, want) + 1e-4 * top
    assert _err(emul, jax_res) <= 5e-5 * jax_res.abs().max().item()


# ---- the fp32 kernels with an attention bias (the BIAS instantiations of
# csrc/flash_fp32.cu and flash_bwd_dbias_fp32_kernel)

BS, BK = 80, 112  # the bias cases' lengths (causal, sq != sk)
# (bias kind, head dim); GQA 4 over 1
BIAS_CASES = [("2d", 64), ("3d", 128), ("1h", 64), ("b1", 128), ("bh", 64)]


def _bias_shape(kind):
    return {"2d": (BS, BK), "3d": (B, BS, BK), "1h": (1, H, BS, BK),
            "b1": (B, 1, BS, BK), "bh": (B, H, BS, BK)}[kind]


@functools.lru_cache(maxsize=None)
def _bias_case(kind, d):
    """numpy q, k, v, bias, dO and the JAX package's fp32 out, LSE, dq, dk,
    dv and dbias of a causal call with the bias (one jax.vjp call)."""
    rng = np.random.default_rng(BIAS_CASES.index((kind, d)) + 70)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, BS, d), (B, HK, BK, d), (B, HK, BK, d))]
    arrays.append(2 * rng.standard_normal(_bias_shape(kind)).astype(np.float32))
    do = rng.standard_normal((B, H, BS, d)).astype(np.float32)
    (out, lse), vjp = jax.vjp(
        lambda q, k, v, bias: jflash_attention(q, k, v, bias, causal=True,
                                               return_lse=True),
        *map(jnp.asarray, arrays))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    to = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return arrays, do, [to(out), to(lse)], [to(g) for g in grads]


def _attention64_bias(q, k, v, bias, do):
    """(out, lse, dq, dk, dv, dbias) in float64, causal, with the bias
    (broadcast as tfwd.bias_view does); dbias in the bias's own shape
    (autograd sums the broadcast axes)."""
    ins = [t.double().requires_grad_() for t in (q, k, v, bias)]
    g = q.shape[1] // k.shape[1]
    s = (ins[0] * q.shape[-1] ** -0.5) @ ins[1].repeat_interleave(
        g, 1).transpose(-1, -2) + ins[3].reshape(
        tfwd.bias_view(bias, B, H, BS, BK).shape)
    s = s.masked_fill(~_keep(BS, BK, True, (-1, -1)), float("-inf"))
    out = torch.softmax(s, -1) @ ins[2].repeat_interleave(g, 1)
    return [out.detach(), torch.logsumexp(s, -1).detach()] + list(
        torch.autograd.grad(out, ins, do.double()))


@pytest.mark.parametrize("kind,d", BIAS_CASES)
def test_tf32x3_bias_meets_the_fp32_contract(kind, d):
    """The emulation with a bias (added after softcap, in fp32): out, LSE,
    dq, dk, dv and dbias under the fp32 contract against float64 (at most
    twice the fp32 plain versions' error + 1e-4, and twice JAX's + 1e-4),
    within 5e-5 of JAX's relative to its largest entry; dbias in the
    bias's broadcast shape, equal to the per-head dbias of the bias
    expanded to (b, h, sq, sk) summed member by member in the kernel's
    order, and within 1e-6 of its largest entry of that sum in torch's
    order."""
    arrays, do, jres, jgrads = _bias_case(kind, d)
    q, k, v, bias = (torch.from_numpy(a) for a in arrays)
    do = torch.from_numpy(do)
    bias4 = tfwd.bias_view(bias, B, H, BS, BK)
    keep = _keep(BS, BK, True, (-1, -1))[None, None]
    kw = dict(sm_scale=d ** -0.5, softcap=0.0)
    out, lse = attention_fwd_tf32x3(q, k, v, mask=keep, bias=bias4, **kw)
    p_out, p_lse = tfwd.attention_fwd_ref(q, k, v, need_lse=True,
                                          causal=True, bias=bias4, **kw)
    grads = attention_bwd_tf32x3(q, k, v, p_out, p_lse, do, mask=keep,
                                 bias=bias4, **kw)
    plain = tbwd.attention_bwd_ref(q, k, v, p_out, p_lse, do, causal=True,
                                   bias=bias4, **kw)
    want = _attention64_bias(q, k, v, bias, do)
    assert grads[3].shape == bias4.shape and grads[3].dtype == torch.float32
    for name, e, p, j, w in zip(
            ("out", "lse", "dq", "dk", "dv", "dbias"), (out, lse) + grads,
            (p_out, p_lse) + plain, jres + jgrads, want):
        e, p = e.reshape(w.shape), p.reshape(w.shape)
        err, err_plain, err_jax = _err(e, w), _err(p, w), _err(j, w)
        assert err <= 2 * err_plain + 1e-4, (name, err, err_plain)
        assert err <= 2 * err_jax + 1e-4, (name, err, err_jax)
        assert _err(e, j) <= 5e-5 * j.abs().max().item(), (name, _err(e, j))
    full = attention_bwd_tf32x3(
        q, k, v, p_out, p_lse, do, mask=keep,
        bias=bias4.expand(B, H, BS, BK).contiguous(), **kw)[3]
    assert torch.equal(grads[3], sum_bias_members(full, bias4.shape))
    dims = tuple(i for i in (0, 1) if bias4.shape[i] == 1)
    summed = full.sum(dims, keepdim=True) if dims else full
    assert _err(grads[3], summed) <= 1e-6 * summed.abs().max().item()
