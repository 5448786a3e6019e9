"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card, which
skips when there is no CUDA device or no CUDA toolkit. On a machine with an
H100 (run from the repository root)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py sets JAX up, and the card's
machine needs no JAX.) Tolerances: the norm to one bf16 unit in the last
place of the largest output; attention by the repository's contract
(error against the fp32 ``attention_ref`` at most twice that of the bf16
baseline); decode, whose kernel and plain version both keep P in fp32, to
one bf16 unit of the largest output (fp32 caches: 1e-5).
"""

import collections
import types

import pytest
import torch

from xhy_flash_attention_tpu_torch.ops import _cuda
from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
from xhy_flash_attention_tpu_torch.ops.flash_attention import decode_kernel as dk
from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as fh
from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import (
    attention_ref,
)

pytestmark = pytest.mark.gpu

BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _cuda.nvcc()
    except RuntimeError:
        pytest.skip("needs the CUDA toolkit (nvcc) to build the kernels")
    _cuda.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("residual", [None, torch.float32, "x0"])
def test_norm_kernel_matches_plain(cuda, dtype, rms, residual):
    rows, hidden = 37, 4096
    x0 = torch.randn(rows, hidden, generator=cuda, device="cuda").to(dtype)
    res = None
    if residual is not None:
        res = 3 * torch.randn(rows, hidden, generator=cuda, device="cuda")
        res = res.to(dtype if residual == "x0" else residual)
    w = 1 + 0.1 * torch.randn(hidden, generator=cuda, device="cuda")
    b = None if rms else 0.1 * torch.randn(hidden, generator=cuda, device="cuda")
    args = (x0, res, w, b, 1e-5, rms, torch.float32, True)
    before = ln.ln_fwd.launches
    out, resout = ln.ln_fwd(*args)
    ref, ref_res = ln.ln_fwd_ref(*args)
    torch.cuda.synchronize()
    assert ln.ln_fwd.launches == before + 1
    tol = (BF16_ULP if dtype == torch.bfloat16 else 1e-6) * ref.float().abs().max().item()
    assert _err(out, ref) <= tol
    assert _err(resout, ref_res) <= 1e-6 * ref_res.abs().max().item()


def _contract(out_bshd, q, k, v, causal, softcap):
    ref, _ = attention_ref(q, k, v, causal=causal, softcap=softcap)
    lp, _ = attention_ref(q, k, v, causal=causal, softcap=softcap,
                          upcast=False, reorder_ops=True)
    assert _err(out_bshd, ref) <= 2 * _err(lp, ref) + 1e-4


def _check_fwd(cuda, b, h, hk, sq, sk, d, causal, softcap):
    q = torch.randn(b, h, sq, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, hk, sk, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, hk, sk, d, generator=cuda, device="cuda").bfloat16()
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=softcap)
    before = fwd.flash_attention_fwd.launches
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
    ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, **kw)
    torch.cuda.synchronize()
    assert fwd.flash_attention_fwd.launches == before + 1
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert _err(lse[finite], ref_lse[finite]) <= 1e-3
    assert not out[~finite].any()  # rows with no visible key give 0
    _contract(out.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
              v.transpose(1, 2), causal, softcap)


# every tile class of the dense kernel (fwd.py fwd_tile_plan): one exact
# tile, a ragged last tile on both axes, long rows, sq < sk and sq > sk
# (rows that see no key when causal)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (129, 2049), (2048, 2048),
                                   (1100, 1100), (77, 300), (300, 77)])
def test_flash_fwd_matches_plain(cuda, sq, sk, causal, softcap, d):
    _check_fwd(cuda, 2, 8, 2, sq, sk, d, causal, softcap)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hk", [8, 2, 1])  # GQA groups 1, 4 and 8
def test_flash_fwd_gqa_groups(cuda, hk, causal, d):
    _check_fwd(cuda, 2, 8, hk, 700, 700, d, causal, 0.0)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_is_deterministic(cuda, d):
    """Two calls on the same inputs give the same bits, out and LSE."""
    b, h, hk, s = 2, 8, 2, 1500
    q = torch.randn(b, h, s, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, hk, s, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, hk, s, d, generator=cuda, device="cuda").bfloat16()
    runs = [fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5, causal=True)
            for _ in range(3)]
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


def test_flash_fwd_misaligned_stride_raises(cuda):
    """The tensor maps need 16-byte strides: a view whose sequence stride
    is not a multiple of 8 elements is refused before any launch."""
    wide = torch.randn(1, 4, 256, 68, device="cuda").bfloat16()
    q = wide[..., :64]  # sequence stride 68 elements = 136 bytes
    k = torch.randn(1, 4, 256, 64, device="cuda").bfloat16()
    before = fwd.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        fwd.flash_attention_fwd(q, k, k, sm_scale=0.125, causal=True)
    odd = torch.randn(1, 4, 256, 76, device="cuda").bfloat16()[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fwd.flash_attention_fwd(k, odd, odd, sm_scale=0.125)
    assert fwd.flash_attention_fwd.launches == before


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hk", [(32, 8), (8, 8), (16, 2)])
def test_fused_heads_matches_plain(cuda, h, hk, d):
    b, s = 2, 960
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=cuda,
                      device="cuda").bfloat16()
    before = fh.fused_heads_fwd.launches
    out = fh.packed_qkv_attention(qkv, num_heads=h, num_heads_kv=hk,
                                  head_dim=d, causal=True)
    assert fh.fused_heads_fwd.launches == before + 1
    q = qkv[..., : h * d].view(b, s, h, d)
    k = qkv[..., h * d: (h + hk) * d].view(b, s, hk, d)
    v = qkv[..., (h + hk) * d:].view(b, s, hk, d)
    ref = fh.fused_heads_fwd_ref(q, k, v, sm_scale=d ** -0.5, causal=True,
                                 softcap=0.0)
    torch.cuda.synchronize()
    assert _err(out.view(b, s, h, d), ref) <= \
        BF16_ULP * ref.float().abs().max().item() + 1e-3
    _contract(out.view(b, s, h, d), q, k, v, True, 0.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("window", [-1, 100])
@pytest.mark.parametrize("sq,h,hk,d", [(1, 32, 8, 128), (2, 32, 8, 128),
                                       (1, 8, 8, 64), (2, 16, 2, 64)])
def test_flash_decode_matches_plain(cuda, sq, h, hk, d, window, softcap, dtype):
    b, S = 3, 1300
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").to(dtype)
    kc = torch.randn(b, hk, S, d, generator=cuda, device="cuda").to(dtype)
    vc = torch.randn(b, hk, S, d, generator=cuda, device="cuda").to(dtype)
    lengths = torch.tensor([S, 1000, 3], dtype=torch.int32, device="cuda")
    kw = dict(window_size=(window, -1), softcap=softcap)
    before = dk.flash_decode.launches
    out = dk.flash_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5, **kw)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert dk.flash_decode.launches == before + 1
    rel = BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _err(out, ref) <= rel * ref.float().abs().max().item() + 1e-6


def test_wrappers_raise_on_what_the_kernels_lack(cuda):
    q = torch.randn(1, 4, 64, 96, device="cuda").bfloat16()
    with pytest.raises(NotImplementedError):
        fwd.flash_attention_fwd(q, q, q, sm_scale=1.0)
    with pytest.raises(ValueError):
        ln.ln_fwd(torch.randn(4, 8, device="cuda"), None,
                  torch.ones(8), None, 1e-5, True, torch.float32, False)


def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    """bf16 kernels on the card against the fp32 plain path on the CPU, for
    a prompt inside the packed-heads gate and one past it."""
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, decode, llama_config_to_gpt_config)
    hf = types.SimpleNamespace(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5)
    cpu = GPTLMHeadModel(llama_config_to_gpt_config(hf), device="cpu")
    gpu = GPTLMHeadModel(llama_config_to_gpt_config(hf, torch.bfloat16))
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    for prompt, max_length in ((40, 48), (1030, 1036)):
        ids = torch.randint(0, 512, (2, prompt), generator=gen)
        seq, ref = decode(cpu, ids, max_length, return_scores=True)
        _, got = decode(gpu, ids, max_length, teacher_outputs=seq,
                        return_scores=True)
        assert _err(got.cpu(), ref) <= 0.05 * ref.abs().max().item()


# ---- paged serving: quantized flash_decode, split-KV, paged decode

QDTYPES = [torch.int8, torch.float8_e4m3fn]


def _quant_pair(cuda, shape, dtype):
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    x = torch.randn(*shape, generator=cuda, device="cuda")
    return quantize_kv(x, dtype) if dtype in QDTYPES else x.to(dtype)


@pytest.mark.parametrize("option,cache", [
    (option, cache) for option in ("plain", "kv_batch_idx", "leftpad_k")
    for cache in [torch.bfloat16] + QDTYPES] + [("strided", torch.bfloat16)])
@pytest.mark.parametrize("sq,h,hk,d,window,softcap",
                         [(1, 32, 8, 128, -1, 0.0), (2, 16, 2, 64, 100, 20.0)])
def test_flash_decode_options_match_plain(cuda, sq, h, hk, d, window, softcap,
                                          option, cache):
    """Quantized payloads, kv_batch_idx, leftpad_k and (b, S, hk, d) caches
    read through strides; both sides keep P in fp32, so one bf16 unit of the
    largest output."""
    b, S = 3, 1300
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    shape = (b, S, hk, d) if option == "strided" else (b, hk, S, d)
    kc, vc = (_quant_pair(cuda, shape, cache) for _ in range(2))
    if option == "strided":  # quantized caches come in (b, hk, S, d)
        kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
    lengths = torch.tensor([S, 1000, 3], dtype=torch.int32, device="cuda")
    kw = dict(window_size=(window, -1), softcap=softcap)
    if option == "kv_batch_idx":
        kw["kv_batch_idx"] = torch.tensor([2, 0, 0], dtype=torch.int32,
                                          device="cuda")
    if option == "leftpad_k":
        lengths = torch.tensor([S - 50, 900, 0], dtype=torch.int32,
                               device="cuda")
        kw["leftpad_k"] = torch.tensor([50, 7, 3], dtype=torch.int32,
                                       device="cuda")
    before = dk.flash_decode.launches
    out = dk.flash_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5, **kw)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert dk.flash_decode.launches == before + 1
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-6


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("num_splits", [0, 1, 2, 3])
def test_splitkv_matches_plain(cuda, num_splits, cache):
    """Partials against splitkv_partials_ref (fp32 on both sides: 1e-5 of
    the largest |v|), and the merged output within one bf16 unit."""
    from xhy_flash_attention_tpu_torch.inference import combine
    b, h, hk, d, S = 2, 32, 8, 128, 2080
    q = torch.randn(b, 1, h, d, generator=cuda, device="cuda").bfloat16()
    kc, vc = (_quant_pair(cuda, (b, hk, S, d), cache) for _ in range(2))
    lengths = torch.tensor([S, 700], dtype=torch.int32, device="cuda")
    before = combine.flash_decode_splitkv.launches
    out = combine.flash_decode_splitkv(q, kc, vc, lengths,
                                       num_splits=num_splits)
    assert combine.flash_decode_splitkv.launches == before + 1
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5)
    torch.cuda.synchronize()
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-6
    splits, split_len = combine._split_plan(q, kc, num_splits, 512)
    rows = h // hk
    outs = torch.empty(b, hk, splits, rows, d, device="cuda")
    ms = torch.empty(b, hk, splits, rows, device="cuda")
    ls = torch.empty_like(ms)
    dk.launch_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5,
                     partials=(outs, ms, ls), split_len=split_len)
    ro, rm, rl = combine.splitkv_partials_ref(q, kc, vc, lengths, d ** -0.5,
                                              splits, split_len)
    torch.cuda.synchronize()
    vmax = (vc.values.float() * vc.scales if cache in QDTYPES
            else vc.float()).abs().max().item()
    assert _err(outs, ro) <= 1e-5 * vmax
    seen = rl > 0
    assert torch.equal(seen, ls > 0)
    assert _err(ms[seen], rm[seen]) <= 1e-5
    assert ((ls - rl).abs() <= 1e-5 * rl.abs()).all()


# ---- the cluster design of csrc/flash_decode.cu

def _partials(cuda, q, kc, vc, lengths, split_len, splits, cluster=None, **kw):
    """flash_decode.cu's partials (and splitkv_partials_ref's) over splits of
    split_len keys."""
    from xhy_flash_attention_tpu_torch.inference import combine
    b, _, h, d = q.shape
    hk = dk._payload(kc)[0].shape[1]
    rows = q.shape[1] * h // hk
    outs = torch.empty(b, hk, splits, rows, d, device="cuda")
    ms = torch.empty(b, hk, splits, rows, device="cuda")
    ls = torch.empty_like(ms)
    dk.launch_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5,
                     partials=(outs, ms, ls), split_len=split_len,
                     cluster=cluster, **kw)
    ref = combine.splitkv_partials_ref(q, kc, vc, lengths, d ** -0.5, splits,
                                       split_len, **kw)
    return (outs, ms, ls), ref


def _assert_partials(got, ref, vc):
    (outs, ms, ls), (ro, rm, rl) = got, ref
    torch.cuda.synchronize()
    vmax = (vc.values.float() * vc.scales if isinstance(vc, dk.QuantizedKV)
            else vc.float()).abs().max().item()
    assert _err(outs, ro) <= 1e-5 * vmax
    seen = rl > 0
    assert torch.equal(seen, ls > 0)
    assert _err(ms[seen], rm[seen]) <= 1e-5
    assert (ms[~seen] == -0.7 * torch.finfo(torch.float32).max).all()
    assert ((ls - rl).abs() <= 1e-5 * rl.abs()).all()


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b", [1, 8])
def test_flash_decode_long_cache(cuda, b, cache):
    """S 8192 (the JAX package's headline decode shape at b8): the whole
    output and the partials of 4 splits of 2048, with the host's plan."""
    h, hk, d, S = 32, 8, 128, 8192
    q = torch.randn(b, 1, h, d, generator=cuda, device="cuda").bfloat16()
    kc, vc = (_quant_pair(cuda, (b, hk, S, d), cache) for _ in range(2))
    lengths = torch.full((b,), S, dtype=torch.int32, device="cuda")
    lengths[1::2] = torch.arange(5000, 5000 + 777 * (b // 2), 777)[:b // 2]
    before = dk.flash_decode.launches
    out = dk.flash_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5)
    torch.cuda.synchronize()
    assert dk.flash_decode.launches == before + 1
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-6
    _assert_partials(*_partials(cuda, q, kc, vc, lengths, 2048, 4), vc)


# lengths ending inside a CTA's chunk, 0 and 3; leftpad and window edges at
# chunk and tile boundaries (S 1300: 21 tiles, chunks of 3 tiles at c = 8)
EDGE_CASES = {
    "ragged": dict(lengths=[1300, 1000, 577, 3, 0, 193]),
    "leftpad": dict(lengths=[1236, 900, 128, 3, 0, 640],
                    leftpad_k=[64, 63, 192, 1297, 5, 0]),
    "window": dict(lengths=[1300, 1000, 577, 3, 0, 193],
                   window_size=(191, -1)),
    "window_leftpad": dict(lengths=[1236, 900, 128, 3, 0, 640],
                           leftpad_k=[64, 63, 192, 1297, 5, 0],
                           window_size=(64, -1)),
}


def _edge_inputs(cuda, case, cache, sq=1, h=32, hk=8, d=128, S=1300):
    spec = dict(EDGE_CASES[case])
    b = len(spec["lengths"])
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    kc, vc = (_quant_pair(cuda, (b, hk, S, d), cache) for _ in range(2))
    lengths = torch.tensor(spec.pop("lengths"), dtype=torch.int32,
                           device="cuda")
    if "leftpad_k" in spec:
        spec["leftpad_k"] = torch.tensor(spec["leftpad_k"], dtype=torch.int32,
                                         device="cuda")
    return q, kc, vc, lengths, spec


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_flash_decode_cluster_sizes(cuda, cluster, case, cache):
    """Every cluster size, forced, against the plain version: the output
    within one bf16 unit, and the partials of splits of 512 keys (the
    splitkv entry takes no leftpad)."""
    q, kc, vc, lengths, kw = _edge_inputs(cuda, case, cache)
    d = q.shape[-1]
    out = torch.empty_like(q)
    dk.launch_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5, out=out,
                     cluster=cluster, **kw)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-6
    assert torch.isfinite(out).all()
    assert not out[lengths == 0].any()
    if "leftpad_k" not in kw:
        _assert_partials(*_partials(cuda, q, kc, vc, lengths, 512, 3,
                                    cluster=cluster, **kw), vc)


def test_flash_decode_is_deterministic(cuda):
    """Two calls of each entry give the same bits (the cluster merges in a
    fixed order)."""
    q, kc, vc, lengths, kw = _edge_inputs(cuda, "window", torch.bfloat16,
                                          sq=2, h=16, hk=4)
    d = q.shape[-1]
    for cluster in (None, 8):
        outs = []
        for _ in range(2):
            out = torch.empty_like(q)
            dk.launch_decode(q, kc, vc, lengths, softmax_scale=d ** -0.5,
                             out=out, cluster=cluster, **kw)
            outs.append(out)
        assert torch.equal(*outs)
        parts = [_partials(cuda, q, kc, vc, lengths, 512, 3,
                           cluster=cluster, **kw)[0] for _ in range(2)]
        for a, b in zip(*parts):
            assert torch.equal(a, b)


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_flash_decode_unaligned_cache_raises(cuda, cache):
    """Key rows arrive by 16-byte copies: a cache whose sequence stride or
    pointer is not a multiple of 16 bytes raises ValueError, as does a
    cluster size the kernel does not take."""
    from xhy_flash_attention_tpu_torch.ops.quant import QuantizedKV
    b, h, hk, d, S = 2, 8, 2, 64, 256
    q = torch.randn(b, 1, h, d, generator=cuda, device="cuda").bfloat16()
    lengths = torch.full((b,), S, dtype=torch.int32, device="cuda")
    pad = 8 // torch.tensor([], dtype=cache).element_size()  # 8 bytes
    wide = _quant_pair(cuda, (b, hk, S, d + pad), torch.bfloat16).to(cache)
    for kc in (wide[..., :d], wide[..., pad:]):  # the stride, the pointer
        if cache == torch.int8:
            kc = QuantizedKV(kc, torch.ones(b, hk, S, 1, device="cuda"))
        with pytest.raises(ValueError, match="multiples of"):
            dk.flash_decode(q, kc, kc, lengths, softmax_scale=0.125)
    kc = wide[..., :d].contiguous()
    if cache == torch.int8:
        kc = QuantizedKV(kc, torch.ones(b, hk, S, 1, device="cuda"))
    with pytest.raises(ValueError, match="cluster"):
        dk.launch_decode(q, kc, kc, lengths, softmax_scale=0.125,
                         out=torch.empty_like(q), cluster=3)
    # q rows arrive by 16-byte copies too: launch_decode raises on a q off
    # that boundary, flash_decode copies it
    q_off = torch.empty(q.numel() + 4, device="cuda").bfloat16()[4:].view(q.shape)
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        dk.launch_decode(q_off, kc, kc, lengths, softmax_scale=0.125,
                         out=torch.empty_like(q))
    assert torch.equal(dk.flash_decode(q_off, kc, kc, lengths, softmax_scale=0.125),
                       dk.flash_decode(q, kc, kc, lengths, softmax_scale=0.125))


@pytest.mark.parametrize("pages", [torch.bfloat16] + QDTYPES)
@pytest.mark.parametrize("d,npp,ps,entry", [(128, 8, 64, "chunked"),
                                            (64, 8, 64, "page"),
                                            (128, 1, 512, "page")])
@pytest.mark.parametrize("sq,window,softcap", [(1, -1, 0.0), (37, 200, 30.0)])
def test_paged_decode_matches_plain(cuda, sq, window, softcap, d, npp, ps,
                                    entry, pages):
    """Both entries over shuffled pages with ragged lengths, a zero-length
    slot and sq * g up to 148 rows; P is rounded to bf16 for P.V on both
    sides: one bf16 unit of the largest output plus 1e-3."""
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    b, h, hk = 4, 32, 8
    cap = npp * ps
    P = b * npp + 1
    kv = torch.randn(P, hk, 2, ps, d, generator=cuda, device="cuda")
    scales = None
    if pages in QDTYPES:
        qkv = quantize_kv(kv, pages)
        kv = qkv.values
        # linear per-sequence scales, random in [0.5, 1.5)
        scales = 0.5 + torch.rand(b, hk, 2, cap, generator=cuda, device="cuda")
    else:
        kv = kv.to(pages)
    perm = torch.randperm(b * npp, generator=cuda, device="cuda")
    table = perm.reshape(b, npp).to(torch.int32)
    lengths = torch.tensor([cap, 0, cap // 2 + 5, max(sq, 3)],
                           dtype=torch.int32, device="cuda")
    cache = paged.PagedKVCache(kv, table, lengths, scales)
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    fn = getattr(paged, f"paged_decode_{entry}")
    before = fn.launches
    out = paged.paged_flash_decode(q, cache, window_size=(window, -1),
                                   softcap=softcap)
    ref = paged.paged_flash_decode_ref(q, cache, d ** -0.5, (window, -1),
                                       softcap)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert not out[1].float().abs().any()
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3


def _paged_case(cuda, pages, *, b=4, sq=1, h=32, hk=8, d=128, ps=64, npp=8,
                lengths=None):
    """A paged cache over shuffled pages (one spare) with ragged lengths
    (a full sequence, an empty slot, a partial one, a short one) and its
    bf16 query; int8 / e4m3 pages carry random linear scales."""
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    cap = npp * ps
    P = b * npp + 1
    kv = torch.randn(P, hk, 2, ps, d, generator=cuda, device="cuda")
    scales = None
    if pages in QDTYPES:
        kv = quantize_kv(kv, pages).values
        scales = 0.5 + torch.rand(b, hk, 2, cap, generator=cuda, device="cuda")
    else:
        kv = kv.to(pages)
    table = torch.randperm(b * npp, generator=cuda, device="cuda").reshape(
        b, npp).to(torch.int32)
    if lengths is None:
        lengths = [cap, 0, cap // 2 + 5, max(sq, 3)][:b]
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    return q, paged.PagedKVCache(kv, table, lengths, scales)


def _paged_close(out, q, cache, window=-1, softcap=0.0):
    from xhy_flash_attention_tpu_torch.inference import paged
    ref = paged.paged_flash_decode_ref(q, cache, q.shape[-1] ** -0.5,
                                       (window, -1), softcap)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert not out[cache.lengths == 0].any()
    # each row (b, si, head) within two bf16 units of its own largest
    # output plus 1e-4 (the outputs' rounding, and P rounded to bf16 at the
    # running max here and at the row's max in the plain version), never
    # more than one unit of the whole output's largest plus 1e-3: rows over
    # thousands of keys have small outputs, and one tolerance from the
    # largest output of the tensor would not see an error in them
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    tol = (2 * BF16_ULP * r.abs().amax(-1) + 1e-4).clamp_max(
        BF16_ULP * r.abs().max() + 1e-3)
    assert ((o - r).abs().amax(-1) <= tol).all(), \
        ((o - r).abs().amax(-1) / tol).max().item()


@pytest.mark.parametrize("pages", [torch.bfloat16] + QDTYPES)
@pytest.mark.parametrize("sq,ps", [(1, 64), (1, 512), (37, 64), (37, 512)])
def test_paged_decode_is_bitwise_repeatable(cuda, sq, ps, pages):
    """Two calls give the same bits in each regime (decode: sq 1; prefill:
    sq 37) and page type, over pages the TMA takes (512) and not (64)."""
    from xhy_flash_attention_tpu_torch.inference import paged
    q, cache = _paged_case(cuda, pages, sq=sq, ps=ps, npp=4096 // ps)
    outs = [paged.paged_flash_decode(q, cache, window_size=(300, -1))
            for _ in range(2)]
    assert torch.equal(*outs)
    _paged_close(outs[0], q, cache, window=300)


@pytest.mark.parametrize("pages", [torch.bfloat16] + QDTYPES)
@pytest.mark.parametrize("d,ps,npp", [(128, 512, 8), (128, 64, 64),
                                      (64, 64, 64)])
def test_paged_prefill_long_sequences(cuda, d, ps, npp, pages):
    """The prefill regime as chunked prefill runs it: no window, sequences
    of up to 4096 keys (32 tiles through the ring), two row blocks of 128
    rows, pages the TMA takes (512, bf16) and not."""
    from xhy_flash_attention_tpu_torch.inference import paged
    q, cache = _paged_case(cuda, pages, sq=64, d=d, ps=ps, npp=npp,
                           lengths=[4096, 0, 2053, 64])
    out = paged.paged_flash_decode(q, cache)
    _paged_close(out, q, cache)


@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("d,window", [(128, -1), (64, 100)])
def test_paged_decode_cluster_sizes(cuda, d, window, cluster, pages):
    """Every cluster size of the decode regime, forced, against the plain
    version (ragged lengths, an empty slot, a window)."""
    from xhy_flash_attention_tpu_torch.inference import paged
    q, cache = _paged_case(cuda, pages, d=d, ps=64, npp=16)
    out = paged.launch_paged(q, cache, softmax_scale=d ** -0.5,
                             window_size=(window, -1), cluster=cluster)
    _paged_close(out, q, cache, window=window)
    with pytest.raises(ValueError, match="cluster"):
        paged.launch_paged(q, cache, softmax_scale=0.1, cluster=3)


@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ps", [16, 40])
@pytest.mark.parametrize("sq,h,hk", [(16, 8, 8), (17, 8, 8), (4, 32, 8),
                                     (5, 32, 8)])
def test_paged_decode_page_sizes_and_regime_boundary(cuda, sq, h, hk, ps,
                                                     pages):
    """Pages of 16 and 40 keys (a 64- or 128-key tile spans pages, and 40
    does not divide it), on both sides of the regime boundary: 16 rows per
    KV head (decode) and 17 (prefill), 16 (g 4) and 20; softcap and a
    window on the prefill side."""
    from xhy_flash_attention_tpu_torch.inference import paged
    q, cache = _paged_case(cuda, pages, sq=sq, h=h, hk=hk, ps=ps, npp=7)
    plan = paged.paged_launch_plan(4, sq, h, hk, ps, 7, 132)
    assert plan["regime"] == ("decode" if sq * h // hk <= 16 else "prefill")
    window, softcap = (-1, 0.0) if plan["regime"] == "decode" else (150, 30.0)
    out = paged.paged_flash_decode(q, cache, window_size=(window, -1),
                                   softcap=softcap)
    _paged_close(out, q, cache, window, softcap)


@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("sq", [1, 37])
def test_paged_decode_in_a_cuda_graph(cuda, sq, pages):
    """paged_flash_decode captured in a CUDA graph, replayed after lengths
    and page_table were changed in place: equal to an eager call on the new
    values (the launch reads no device value on the host)."""
    from xhy_flash_attention_tpu_torch.inference import paged
    q, cache = _paged_case(cuda, pages, sq=sq, ps=64, npp=16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged.paged_flash_decode(q, cache)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged.paged_flash_decode(q, cache)
    cache.lengths.copy_(torch.tensor([700, 1024, 0, 64], dtype=torch.int32))
    cache.page_table.copy_(cache.page_table.flip(0).roll(5, 1))
    graph.replay()
    eager = paged.paged_flash_decode(q, cache)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _paged_close(out, q, cache)


def test_paged_append_on_the_card(cuda):
    """append_paged_kv through CUDA index_put equals the same append on
    the CPU, bit for bit (e4m3 pages and scales)."""
    from xhy_flash_attention_tpu_torch.inference import paged
    b, hk, d, ps, npp = 3, 2, 64, 16, 3
    caches = {}
    for dev in ("cpu", "cuda"):
        c = paged.PagedKVCache.create(b * npp + 1, hk, ps, d, b, npp,
                                      torch.float8_e4m3fn, device=dev)
        c.page_table.copy_(torch.arange(b * npp).reshape(b, npp))
        c.lengths.copy_(torch.tensor([5, 0, npp * ps - 1]))
        caches[dev] = c
    k = torch.randn(b, hk, 4, d, generator=torch.Generator().manual_seed(1))
    out = {dev: paged.append_paged_kv(c, k.to(dev), (2 * k).to(dev))
           for dev, c in caches.items()}
    assert torch.equal(out["cuda"].kv_pages.view(torch.uint8).cpu(),
                       out["cpu"].kv_pages.view(torch.uint8))
    assert torch.equal(out["cuda"].kv_scales.cpu(), out["cpu"].kv_scales)
    assert out["cuda"].lengths.tolist() == [9, 0, npp * ps + 3]


# ---- training: attention backward (dK/dV, dQ, packed dqkv), norm backward

def _grad_contract(grads, q, k, v, do, causal, softcap):
    """Each kernel gradient against the fp32 `attention_ref` gradient: at
    most twice the error of the bf16 reorder-ops baseline's gradient."""
    def ref_grads(upcast, reorder):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, _ = attention_ref(*ins, causal=causal, softcap=softcap,
                               upcast=upcast, reorder_ops=reorder)
        return torch.autograd.grad(out, ins, do)
    want = ref_grads(True, False)
    low = ref_grads(False, True)
    for got, w, lo in zip(grads, want, low):
        assert _err(got, w) <= 2 * _err(lo, w) + 1e-3


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1100, 1100), (77, 300), (300, 77)])
def test_flash_bwd_matches_plain(cuda, sq, sk, causal, softcap, d):
    """dK/dV and dQ kernels (GQA, h 8 over hk 2) against the plain backward
    on the same forward outputs: four bf16 units of each gradient's largest
    entry (both round P and dS to bf16, in sums of another order); and the
    repository's contract against the fp32 reference."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, hk = 2, 8, 2
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, sk, hk, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, sk, hk, d, generator=cuda, device="cuda").bfloat16()
    do = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=softcap)
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    before = (bwd.flash_bwd_dkv.launches, bwd.flash_bwd_dq.launches)
    got = bwd.flash_attention_bwd(qt, kt, vt, out, lse, dot, **kw)
    want = bwd.attention_bwd_ref(qt, kt, vt, out, lse, dot, **kw)
    torch.cuda.synchronize()
    assert (bwd.flash_bwd_dkv.launches, bwd.flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    _grad_contract([g.transpose(1, 2) for g in got], q, k, v, do, causal,
                   softcap)


def test_flash_bwd_is_deterministic(cuda):
    """Three backward passes give bitwise equal dq, dk and dv (no atomics:
    every output element is summed by one thread in a fixed order)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import flash_attn_func
    b, s, h, hk, d = 2, 1100, 8, 2, 128
    q = torch.randn(b, s, h, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, s, hk, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, s, hk, d, generator=cuda, device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=cuda, device="cuda").bfloat16()
    runs = []
    for _ in range(3):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = flash_attn_func(*ins, causal=True)
        runs.append(torch.autograd.grad(out, ins, do))
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))


def _bwd_case(cuda, b, h, hk, sq, sk, d, causal, softcap):
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, sk, hk, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, sk, hk, d, generator=cuda, device="cuda").bfloat16()
    do = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=softcap)
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    return (q, k, v, do), (qt, kt, vt, out, lse, dot), kw


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 0.0),
                                            (True, 20.0)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,sk", [(100, 1000), (1000, 100), (256, 256),
                                   (2048, 2048), (200, 333), (64, 64)])
def test_flash_bwd_dense_kernels_match_plain(cuda, sq, sk, g, causal, softcap,
                                             d):
    """The dense (wgmma) dK/dV and dQ kernels and the pre-pass, one launch
    each, against the plain backward: GQA groups 1 and 4, sq != sk, sq
    below one block, sk off the 128-key grid, ragged query tiles, softcap;
    four bf16 units of each gradient's largest entry (both round P and dS
    to bf16, in sums of another order)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, hk = 2, 2
    _, (qt, kt, vt, out, lse, dot), kw = _bwd_case(
        cuda, b, g * hk, hk, sq, sk, d, causal, softcap)
    count = lambda: (bwd.flash_bwd_prep.launches, bwd.flash_bwd_dkv.launches,
                     bwd.flash_bwd_dq.launches)
    before = count()
    got = bwd.flash_attention_bwd(qt, kt, vt, out, lse, dot, **kw)
    want = bwd.attention_bwd_ref(qt, kt, vt, out, lse, dot, **kw)
    torch.cuda.synchronize()
    assert count() == tuple(n + 1 for n in before)
    for gr, w in zip(got, want):
        assert gr.shape == w.shape and bool(torch.isfinite(gr).all())
        assert _err(gr, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale_q", [False, True])
def test_flash_bwd_prep_matches_plain(cuda, scale_q, d):
    """The pre-pass on strided (b, s, h, d) views: q_s bit for bit the
    plain version's, delta within 1e-5 of the largest |delta| (fp32 sums in
    another order)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, s, h = 3, 333, 4
    q, out, do = (torch.randn(b, s, h, d, generator=cuda, device="cuda")
                  .bfloat16().transpose(1, 2) for _ in range(3))
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=d ** -0.5,
                                   scale_q=scale_q)
    want_qs, want = bwd.bwd_prep_ref(q, out, do, sm_scale=d ** -0.5,
                                     scale_q=scale_q)
    torch.cuda.synchronize()
    assert delta.shape == (b, h, s) and delta.is_contiguous()
    assert _err(delta, want) <= 1e-5 * want.abs().max().item()
    assert (qs is None) == (not scale_q)
    if scale_q:
        assert torch.equal(qs, want_qs)


@pytest.mark.parametrize("layout", ["d64", "d128", "packed"])
def test_flash_bwd_dense_is_bitwise_deterministic(cuda, layout):
    """Three backward passes of the dense kernels give bitwise equal dq, dk
    and dv: at d 64 and d 128 through flash_attention (GQA 4), and through
    the packed dqkv of packed_qkv_attention (#6)."""
    b, s, h, hk = 2, 1000, 8, 2
    if layout == "packed":
        d = 64
        qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=cuda,
                          device="cuda").bfloat16()
        do = torch.randn(b, s, h * d, generator=cuda, device="cuda").bfloat16()

        def grads():
            x = qkv.detach().clone().requires_grad_()
            out = fh.packed_qkv_attention(x, num_heads=h, num_heads_kv=hk,
                                          head_dim=d, causal=True)
            return torch.autograd.grad(out, x, do)
    else:
        from xhy_flash_attention_tpu_torch.ops.flash_attention import \
            flash_attn_func
        d = int(layout[1:])
        (q, k, v, do), _, _ = _bwd_case(cuda, b, h, hk, s, s, d, True, 0.0)

        def grads():
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(flash_attn_func(*ins, causal=True),
                                       ins, do)
    runs = [grads() for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))


@pytest.mark.parametrize("causal,softcap", [(False, 0.0), (True, 30.0)])
def test_fused_heads_bwd_full_and_softcap(cuda, causal, softcap):
    """The packed entry (#6) without the causal mask and with softcap,
    through strides into one dqkv, against the plain version."""
    b, s, h, hk, d = 2, 700, 8, 2, 128
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=cuda,
                      device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=cuda, device="cuda").bfloat16()
    q, k, v = fh._split(qkv, h, hk, d)
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=softcap)
    out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
    dqkv = torch.empty_like(qkv)
    got = fh.fused_heads_bwd(q, k, v, out, lse, do, **kw, **dict(zip(
        ("dq", "dk", "dv"), fh._split(dqkv, h, hk, d))))
    want = fh.fused_heads_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for gr, w in zip(got, want):
        assert _err(gr, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4


def test_flash_bwd_misaligned_stride_raises(cuda):
    """The dense kernels read through TMA: a stride that is not a multiple
    of 16 bytes is a ValueError, not a fault."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, s, h, d = 1, 128, 2, 64
    base = torch.randn(b, h, s, d + 4, device="cuda").bfloat16()
    q = base[..., :d]  # row stride d + 4 elements
    k = v = do = torch.randn(b, h, s, d, device="cuda").bfloat16()
    lse = torch.zeros(b, h, s, device="cuda")
    dq, dk, dv = (torch.empty_like(k) for _ in range(3))
    with pytest.raises(ValueError, match="multiples of 8"):
        bwd.launch_flash_bwd("dkv", q, k, v, do, lse, lse, dq, dk, dv,
                             sm_scale=0.125, causal=True, softcap=0.0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hk", [(8, 8), (8, 2)])
def test_fused_heads_bwd_matches_plain(cuda, h, hk, d):
    """The packed entry: one dqkv in [dq | dk | dv] column order, written
    through strides, against the plain version and the contract."""
    b, s = 2, 960
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=cuda,
                      device="cuda").bfloat16().requires_grad_()
    do = torch.randn(b, s, h * d, generator=cuda, device="cuda").bfloat16()
    before = (fh.fused_heads_fwd.launches, fh.fused_heads_bwd.launches)
    out = fh.packed_qkv_attention(qkv, num_heads=h, num_heads_kv=hk,
                                  head_dim=d, causal=True)
    dqkv, = torch.autograd.grad(out, qkv, do)
    assert (fh.fused_heads_fwd.launches, fh.fused_heads_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    q, k, v = fh._split(qkv.detach(), h, hk, d)
    ref_out, lse = fh.fused_heads_fwd_ref(q, k, v, sm_scale=d ** -0.5,
                                          causal=True, softcap=0.0,
                                          need_lse=True)
    want = fh.fused_heads_bwd_ref(q, k, v, ref_out, lse, do.view(b, s, h, d),
                                  sm_scale=d ** -0.5, causal=True,
                                  softcap=0.0)
    torch.cuda.synchronize()
    for g, w in zip(fh._split(dqkv, h, hk, d), want):
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    _grad_contract(fh._split(dqkv, h, hk, d), q, k, v, do.view(b, s, h, d),
                   True, 0.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("residual", [None, torch.float32, "x0"])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("rows,hidden", [(37, 4096), (5000, 1024)])
def test_ln_bwd_matches_plain(cuda, rows, hidden, prenorm, residual, rms,
                              dtype):
    """The norm backward against its plain version on the same saved
    forward: dx0 to one unit in the last place of its dtype (of the largest
    entry), dresidual likewise, dgamma / dbeta (fp32 sums of another order
    over the rows) to 1e-4 of the largest entry."""
    x0 = torch.randn(rows, hidden, generator=cuda, device="cuda").to(dtype)
    res = None
    if residual is not None:
        res = 3 * torch.randn(rows, hidden, generator=cuda, device="cuda")
        res = res.to(dtype if residual == "x0" else residual)
    w = 1 + 0.1 * torch.randn(hidden, generator=cuda, device="cuda")
    b = None if rms else 0.1 * torch.randn(hidden, generator=cuda, device="cuda")
    res_dtype = torch.float32
    _, resout, mu, rstd = ln.ln_fwd(x0, res, w, b, 1e-5, rms, res_dtype,
                                    True, True)
    _, ref_res, ref_mu, ref_rstd = ln.ln_fwd_ref(x0, res, w, b, 1e-5, rms,
                                                 res_dtype, True, True)
    assert _err(rstd, ref_rstd) <= 1e-5 * ref_rstd.abs().max().item()
    if not rms:
        assert _err(mu, ref_mu) <= 1e-5 * ref_mu.abs().max().item() + 1e-6
    dout = torch.randn(rows, hidden, generator=cuda, device="cuda").to(dtype)
    dres_in = (torch.randn(rows, hidden, generator=cuda, device="cuda")
               if prenorm else None)
    kw = dict(is_rms=rms, has_bias=b is not None, x0_dtype=dtype,
              res_dtype=None if res is None else res.dtype)
    before = ln.ln_bwd.launches
    got = ln.ln_bwd(dout, dres_in, resout, mu, rstd, w, **kw)
    want = ln.ln_bwd_ref(dout, dres_in, resout, mu, rstd, w, **kw)
    torch.cuda.synchronize()
    assert ln.ln_bwd.launches == before + 1
    for i, (g, wt) in enumerate(zip(got, want)):
        assert (g is None) == (wt is None)
        if g is None:
            continue
        assert g.dtype == wt.dtype and g.shape == wt.shape
        scale = wt.float().abs().max().item()
        if i < 2:
            ulp = BF16_ULP if g.dtype == torch.bfloat16 else 1e-6
            assert _err(g, wt) <= ulp * scale + 1e-6
        else:
            assert _err(g, wt) <= 1e-4 * scale


# ------------------------------ the fused norm's dropout, rowscale, colscale

NORM_SEED = (1 << 31) + 12345  # above int32: the low 32 bits key the mask


def _norm_inputs(gen, rows, hidden, dtype, rms, rowscale, colscale):
    z = dict(generator=gen, device="cuda")
    x0 = torch.randn(rows, hidden, **z).to(dtype)
    res = 3 * torch.randn(rows, hidden, **z)
    w = 1 + 0.1 * torch.randn(hidden, **z)
    b = None if rms else 0.1 * torch.randn(hidden, **z)
    rs = 0.5 + torch.rand(rows, **z) if rowscale else None
    cs = 1 + 0.2 * torch.randn(hidden, **z) if colscale else None
    return x0, res, w, b, rs, cs


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("colscale", [False, True])
@pytest.mark.parametrize("rowscale", [False, True])
@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,hidden", [(37, 4096), (5000, 1024)])
def test_norm_flags_match_plain(cuda, rows, hidden, dtype, rms, rowscale,
                                colscale, dropout):
    """Every flag combination of #7 / #8 against the plain versions, prenorm
    with an fp32 residual, at a row count that no block of the backward
    divides (5000 rows, 19 a block): residual_out bit for bit (the same
    fp32 products in the same order), out to one bf16 unit of its largest
    entry (1e-6 in fp32), dx0 and dresidual likewise, dgamma / dbeta /
    dcolscale to 1e-4 of theirs; with dropout dx0's zeros are the keep
    mask's."""
    x0, res, w, b, rs, cs = _norm_inputs(cuda, rows, hidden, dtype, rms,
                                         rowscale, colscale)
    flags = dict(rowscale=rs, colscale=cs, dropout_p=0.17 if dropout else 0.0,
                 seed=NORM_SEED & 0xFFFFFFFF if dropout else None)
    args = (x0, res, w, b, 1e-5, rms, torch.float32, True, True)
    inst = ln.norm_instance(rms, rowscale, colscale)
    before = (ln.ln_fwd.launches, ln.ln_fwd.dropout_launches[inst])
    out, resout, mu, rstd = ln.ln_fwd(*args, **flags)
    ref, ref_res, _, _ = ln.ln_fwd_ref(*args, **flags)
    torch.cuda.synchronize()
    assert (ln.ln_fwd.launches, ln.ln_fwd.dropout_launches[inst]) == (
        before[0] + 1, before[1] + dropout)
    assert torch.equal(resout, ref_res)
    ulp = BF16_ULP if dtype == torch.bfloat16 else 1e-6
    assert _err(out, ref) <= ulp * ref.float().abs().max().item()
    dout = torch.randn(rows, hidden, generator=cuda, device="cuda").to(dtype)
    dres_in = torch.randn(rows, hidden, generator=cuda, device="cuda")
    kw = dict(is_rms=rms, has_bias=b is not None, x0_dtype=dtype,
              res_dtype=torch.float32, x0=x0, **flags)
    before = (ln.ln_bwd.launches, ln.ln_bwd.dropout_launches[inst])
    got = ln.ln_bwd(dout, dres_in, resout, mu, rstd, w, **kw)
    want = ln.ln_bwd_ref(dout, dres_in, resout, mu, rstd, w, **kw)
    torch.cuda.synchronize()
    assert (ln.ln_bwd.launches, ln.ln_bwd.dropout_launches[inst]) == (
        before[0] + 1, before[1] + dropout)
    assert (got[4] is None) == (not colscale)
    for i, (g, wt) in enumerate(zip(got, want)):
        assert (g is None) == (wt is None)
        if g is None:
            continue
        assert g.dtype == wt.dtype and g.shape == wt.shape
        scale = wt.float().abs().max().item()
        if i < 2:
            u = BF16_ULP if g.dtype == torch.bfloat16 else 1e-6
            assert _err(g, wt) <= u * scale + 1e-6, i
        else:
            assert _err(g, wt) <= 1e-4 * scale, i
    if dropout:
        keep = ln.norm_keep_mask(flags["seed"], 0.17, rows, hidden, "cuda")
        assert torch.equal(got[0] != 0, keep)


@pytest.mark.parametrize("p", [0.1, 0.17])
@pytest.mark.parametrize("rows,hidden", [(37, 4096), (5000, 1024)])
def test_norm_keep_mask_bit_for_bit(cuda, rows, hidden, p):
    """x0 = 1, residual 0, unit scales: residual_out is the keep mask times
    1 / (1 - p), exactly, against ops common.py's dropout_keep_mask on the
    global (row, col) with salt 0; the seed above int32 keys by its low 32
    bits."""
    ones = torch.ones(rows, hidden, device="cuda")
    zeros = torch.zeros(rows, hidden, device="cuda")
    unit_r = torch.ones(rows, device="cuda")
    unit_c = torch.ones(hidden, device="cuda")
    _, resout = ln.ln_fwd(ones, zeros, unit_c, None, 1e-5, True,
                          torch.float32, True, rowscale=unit_r,
                          colscale=unit_c, dropout_p=p,
                          seed=NORM_SEED & 0xFFFFFFFF)
    keep = ln.norm_keep_mask(NORM_SEED, p, rows, hidden, "cuda")
    want = torch.where(keep, torch.ones_like(ones), 0.0) * (1.0 / (1.0 - p))
    assert torch.equal(resout, want)
    assert abs(keep.float().mean().item() - (1 - p)) < 0.02


@pytest.mark.parametrize("rms", [True, False])
def test_norm_flags_backward_is_bitwise_repeatable(cuda, rms):
    """Three backward passes with every flag: dx0, dresidual and the
    dgamma / dbeta / dcolscale sums bitwise equal (partials summed in a
    fixed order, no atomics)."""
    rows, hidden = 5000, 1024
    x0, res, w, b, rs, cs = _norm_inputs(cuda, rows, hidden, torch.bfloat16,
                                         rms, True, True)
    flags = dict(rowscale=rs, colscale=cs, dropout_p=0.1, seed=7)
    _, resout, mu, rstd = ln.ln_fwd(x0, res, w, b, 1e-5, rms, torch.float32,
                                    True, True, **flags)
    dout = torch.randn(rows, hidden, generator=cuda, device="cuda").bfloat16()
    kw = dict(is_rms=rms, has_bias=b is not None, x0_dtype=torch.bfloat16,
              res_dtype=torch.float32, x0=x0, **flags)
    runs = [ln.ln_bwd(dout, None, resout, mu, rstd, w, **kw)
            for _ in range(3)]
    for run in runs[1:]:
        for a, c in zip(runs[0], run):
            assert (a is None and c is None) or torch.equal(a, c)


def test_norm_autograd_with_flags_on_the_card(cuda, monkeypatch):
    """dropout_add_layer_norm with dropout, rowscale and layerscale through
    the autograd function on the card (the plain versions patched to raise:
    a CUDA tensor never takes them) against the same call on CPU tensors
    (the plain versions): residual_out bit for bit, out and the bf16
    gradients to one bf16 unit of their largest entry, the fp32 ones to
    1e-4 of theirs; fp16 is refused."""
    rows, hidden = 300, 512
    x0, res, w, b, rs, cs = _norm_inputs(cuda, rows, hidden, torch.bfloat16,
                                         False, True, True)
    leaves = [t.detach().requires_grad_() for t in (x0, res, w, b, cs)]
    cpu = [t.detach().cpu().requires_grad_() for t in (x0, res, w, b, cs)]

    def call(x0_, res_, w_, b_, cs_, rs_):
        return ln.dropout_add_layer_norm(
            x0_.view(3, 100, hidden), res_.view(3, 100, hidden), w_, b_, 0.1,
            1e-5, rowscale=rs_.view(3, 100), layerscale=cs_, prenorm=True,
            residual_in_fp32=True, seed=NORM_SEED)
    want = call(*cpu, rs.cpu())
    grads_want = torch.autograd.grad(want, cpu, [torch.ones_like(want[0]),
                                                 torch.ones_like(want[1])])

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(ln, "ln_fwd_ref", refuse)
    monkeypatch.setattr(ln, "ln_bwd_ref", refuse)
    inst = ln.norm_instance(False, True, True)
    before = (collections.Counter(ln.ln_fwd.dropout_launches),
              collections.Counter(ln.ln_bwd.dropout_launches))
    got = call(*leaves, rs)
    grads = torch.autograd.grad(got, leaves, [torch.ones_like(got[0]),
                                              torch.ones_like(got[1])])
    torch.cuda.synchronize()
    assert (ln.ln_fwd.dropout_launches - before[0],
            ln.ln_bwd.dropout_launches - before[1]) == (
        collections.Counter({inst: 1}), collections.Counter({inst: 1}))
    assert torch.equal(got[1].cpu(), want[1].detach())
    scale = want[0].float().abs().max().item()
    assert _err(got[0].cpu(), want[0]) <= BF16_ULP * scale
    for g, wt in zip(grads, grads_want):
        assert g.dtype == wt.dtype
        u = BF16_ULP if g.dtype == torch.bfloat16 else 1e-4
        assert _err(g.cpu(), wt) <= u * wt.float().abs().max().item() + 1e-5
    with pytest.raises(TypeError):
        ln.dropout_add_layer_norm(x0.half(), None, w, b, 0.1, 1e-5, seed=1)


@pytest.mark.parametrize("rotary", [False, True])
def test_two_layer_model_trains_on_the_card(cuda, rotary):
    """A 2-layer bf16 GPT on the card: the norm's outputs carry a grad_fn
    (no gradient is cut at the kernel), every parameter gets a finite,
    non-zero gradient, and the backward ran through the kernels. hidden 256
    with 4 heads: without rotary the packed route (kernels #5/#6), with
    rotary (and s > 1024) flash_attention (#1, #2/#3)."""
    from xhy_flash_attention_tpu_torch import GPTConfig, GPTLMHeadModel
    from xhy_flash_attention_tpu_torch.losses import cross_entropy_loss
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    s = 1100 if rotary else 512
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=0 if rotary
                    else s, rotary_emb_fraction=0.5 if rotary else 0.0,
                    dtype=torch.bfloat16)
    model = GPTLMHeadModel(cfg, device="cuda")
    ids = torch.randint(0, 512, (2, s + 1), generator=cuda, device="cuda")
    counts = lambda: (ln.ln_fwd.launches, ln.ln_bwd.launches,
                      bwd.flash_bwd_dkv.launches, bwd.flash_bwd_dq.launches,
                      fh.fused_heads_bwd.launches)
    before = counts()
    normed = model.transformer.layers[0].norm1(
        model.transformer.embeddings(ids[:, :-1]), None, True, True)
    assert normed[0].grad_fn is not None and normed[1].grad_fn is not None
    logits, _ = model(ids[:, :-1])
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              ids[:, 1:].reshape(-1)).mean()
    loss.backward()
    torch.cuda.synchronize()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert p.grad.float().abs().max().item() > 0, name
    delta = [a - c for a, c in zip(counts(), before)]
    assert delta[0] == 2 * 2 + 1 + 1 and delta[1] == 2 * 2 + 1
    assert delta[2:] == ([2, 2, 0] if rotary else [0, 0, 2])


# ---- sparse masks: FlashMask and block-sparse attention, reduced scores

def _sparse_case(cuda, b, h, hk, s, d):
    q, do = (torch.randn(b, s, h, d, generator=cuda, device="cuda").bfloat16()
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, hk, d, generator=cuda, device="cuda").bfloat16()
            .transpose(1, 2) for _ in range(2))
    return q, k, v, do


def _random_bands(cuda, causal, nv, b, hm, sk):
    """Random bands as tests/test_flashmask.py draws them, (b, hm, NV, sk)."""
    def ints(lo, hi):  # uniform in [lo, hi), hi a tensor or an int
        u = torch.rand(b, hm, sk, generator=cuda, device="cuda")
        return (lo + u * (hi - lo)).long()
    lts = ints(0, sk + 1)
    if causal and nv == 1:
        vecs = [lts]
    elif causal:
        vecs = [lts, torch.clamp(lts + ints(0, sk), max=sk)]
    elif nv == 2:
        vecs = [lts, ints(0, lts + 1)]
    else:
        uts = ints(0, sk + 1)
        vecs = [lts, torch.clamp(lts + ints(0, sk // 2), max=sk), uts,
                torch.clamp(uts + ints(0, sk // 2), max=sk)]
    return torch.stack(vecs, 2).to(torch.int32)


def _sparse_kernels_vs_plain(q, k, v, do, causal, masks, softcap=0.0):
    """Forward and both backward kernels against the plain versions with
    the dense mask, on the same inputs: out to one bf16 unit of its largest
    entry (+1e-3), the finite LSE to 1e-3 and the same rows +inf, gradients
    to four bf16 units; each kernel launched once. Then the forward and
    both backward kernels launched directly into buffers filled with NaN:
    the same outputs bit for bit, and the tiles each kernel counts
    (visited, of them elementwise) those of fwd.py's and bwd.py's
    mirrors."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common
    b, h, sq, d = q.shape
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=softcap)
    mask = common.dense_keep_mask(sq, k.shape[2], h, **masks)
    before = (fwd.flash_attention_fwd.launches, bwd.flash_bwd_dkv.launches,
              bwd.flash_bwd_dq.launches)
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw, **masks)
    ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=mask,
                                         **kw)
    got = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw, **masks)
    want = bwd.attention_bwd_ref(q, k, v, out, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    assert (fwd.flash_attention_fwd.launches, bwd.flash_bwd_dkv.launches,
            bwd.flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert _err(lse[finite], ref_lse[finite]) <= 1e-3
    assert not out[~finite].float().abs().any()
    for g, w in zip(got, want):
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    sk, hk = k.shape[2], k.shape[1]
    kmasks = common.KernelMasks(b, h, sq, sk, **masks)
    out2, lse2 = (torch.full_like(t, float("nan")) for t in (out, lse))
    fwd_counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fwd.launch_flash_fwd(q, k, v, out2, lse2, masks=kmasks,
                         tile_counts=fwd_counts, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    plan = fwd.fwd_masked_tile_plan(kmasks, b, h, sq, sk, causal)
    tiles = [e for es in plan.values() for e in es]
    assert fwd_counts[1:].tolist() == [len(tiles),
                                       sum(1 for e in tiles if e[1])]
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    direct = [torch.full_like(t, float("nan")) for t in got]
    counted = []
    for fn in (bwd.flash_bwd_dkv, bwd.flash_bwd_dq):
        counts = torch.zeros(3, dtype=torch.int32, device="cuda")
        fn(qs, k, v, do, lse, delta, *direct, masks=kmasks,
           tile_counts=counts, **kw)
        counted.append(counts[1:].tolist())
    assert all(torch.equal(a, c) for a, c in zip(direct, got))
    mirrors = (bwd.bwd_masked_dkv_tile_plan(kmasks, b, h, hk, sq, sk, causal),
               bwd.bwd_masked_dq_tile_plan(kmasks, b, h, hk, sq, sk, causal,
                                           d))
    assert counted == [
        [len(tiles), sum(1 for e in tiles if e[-2])]
        for tiles in ([e for es in plan.values() for e in es]
                      for plan in mirrors)]
    return got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hm", [1, 8])
@pytest.mark.parametrize("causal,nv", [(True, 1), (True, 2), (False, 2),
                                       (False, 4)])
def test_flashmask_kernels_match_plain(cuda, causal, nv, hm, d):
    """Every FlashMask mode, one mask for all heads and one per head, GQA
    (h 8 over hk 2), s 300: a tail tile of 44 keys (the vectors padded as
    fully masked columns) and random bands that mask some rows fully."""
    b, h, hk, s = 2, 8, 2, 300
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    vecs = _random_bands(cuda, causal, nv, b, hm, s)
    _sparse_kernels_vs_plain(q, k, v, do, causal, dict(
        flashmask_vecs=vecs, flashmask_mode=f"{'causal' if causal else 'full'}_{nv}"))


def test_flashmask_fully_masked_rows_on_the_card(cuda):
    """Rows that see no key give out 0 and LSE +inf: LTStart = 0 on every
    column (causal_1) masks all rows; LTEnd = 100 on the first 64 keys
    (causal_2) masks the first tile of rows 64-99, which see later keys."""
    b, h, s, d = 1, 4, 256, 64
    q, k, v, do = _sparse_case(cuda, b, h, h, s, d)
    zeros = torch.zeros(b, 1, 1, s, dtype=torch.int32, device="cuda")
    out, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5,
                                       causal=True, flashmask_vecs=zeros,
                                       flashmask_mode="causal_1")
    torch.cuda.synchronize()
    assert not out.float().abs().any() and torch.isinf(lse).all()
    cols = torch.arange(s, device="cuda")
    lte = torch.where(cols < 64, 100, 0).to(torch.int32)
    vecs = torch.stack([torch.zeros_like(lte), lte])[None, None]
    _sparse_kernels_vs_plain(q, k, v, do, True, dict(
        flashmask_vecs=vecs, flashmask_mode="causal_2"))


@pytest.mark.parametrize("d", [64, 128])
def test_block_mask_fully_masked_rows_on_the_card(cuda, d):
    """Rows whose block-mask row is all off give out 0 and LSE +inf: the
    second 64 rows of a 128-row block (granularity 64) and a whole block
    of 128 rows, which the producer hands over with no tile."""
    b, h, s = 2, 4, 384
    q, k, v, do = _sparse_case(cuda, b, h, h, s, d)
    bm = torch.ones(b, 1, s // 64, s // 64, dtype=torch.int32, device="cuda")
    bm[:, :, 1] = 0
    bm[:, :, 4:6] = 0
    out, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5,
                                       block_mask=(bm, 64, 64))
    torch.cuda.synchronize()
    for rows in (slice(64, 128), slice(256, 384)):
        assert not out[:, :, rows].float().abs().any()
        assert torch.isinf(lse[:, :, rows]).all()
    _sparse_kernels_vs_plain(q, k, v, do, False, dict(block_mask=(bm, 64, 64)))


def test_flashmask_bwd_is_deterministic(cuda):
    """Two backward passes through a causal document mask give bitwise
    equal dq, dk and dv."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        causal_document_mask, flashmask_attention)
    b, h, hk, s, d = 2, 8, 2, 1100, 128
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    doc = (torch.arange(s, device="cuda") // 150)[None].expand(b, s)
    idx = causal_document_mask(doc)
    runs = []
    for _ in range(2):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = flashmask_attention(*ins, idx, causal=True)
        runs.append(torch.autograd.grad(out, ins, do))
    assert all(torch.equal(a, c) for a, c in zip(*runs))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hm", [1, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_blocksparse_kernels_match_plain(cuda, causal, hm, d):
    """A random 0/1 mask at granularity (128, 256) over s 700 (tail blocks
    in both axes), with one block row off: its rows see nothing."""
    b, h, hk, s = 2, 8, 2, 700
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    gq, gk = 128, 256
    bm = (torch.rand(1, hm, -(-s // gq), -(-s // gk), generator=cuda,
                     device="cuda") < 0.6).to(torch.int32)
    bm[:, :, 1] = 0
    _sparse_kernels_vs_plain(q, k, v, do, causal,
                             dict(block_mask=(bm, gq, gk)))


def _bigbird(cuda, b, s, g):
    """BS's pattern at granularity g: a band of +-1 block, block column 0
    and one random block per block row; (b, 1, nb, nb) int32."""
    nb = -(-s // g)
    i = torch.arange(nb, device="cuda")
    m = ((i[:, None] - i[None, :]).abs() <= 1) | (i[None, :] == 0)
    m = m[None].repeat(b, 1, 1)
    m.scatter_(2, torch.randint(0, nb, (b, nb, 1), generator=cuda,
                                device="cuda"), True)
    return m[:, None].to(torch.int32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_block_mask_at_granularity_64(cuda, causal, d):
    """A block mask at granularity (64, 64) through attention(masks=...):
    the backward's 128-key and 128-row blocks straddle two entries (a dK/dV
    consumer's 64 keys on, the other's off; a dQ tile's two 64-key parts
    differing), s 200 (ragged), GQA; gradients through autograd against
    the plain backward."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common
    from xhy_flash_attention_tpu_torch.ops.flash_attention.interface import \
        attention
    b, h, hk, s = 2, 4, 2, 200
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    bm = (torch.rand(b, h, 4, 4, generator=cuda, device="cuda") < 0.5
          ).to(torch.int32)
    masks = dict(block_mask=(bm, 64, 64))
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = attention(*ins, softmax_scale=None, causal=causal,
                         return_lse=True, masks=masks)
    got = torch.autograd.grad(out, ins, do)
    want = bwd.attention_bwd_ref(
        q, k, v, out.detach(), lse, do, sm_scale=d ** -0.5, causal=causal,
        softcap=0.0, mask=common.dense_keep_mask(s, s, h, **masks))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    _sparse_kernels_vs_plain(q, k, v, do, causal, masks)


@pytest.mark.parametrize("d", [64, 128])
def test_masked_bwd_with_softcap(cuda, d):
    """Softcap under a FlashMask (causal_2, per-head mask heads, GQA) and
    under a block mask, s 200."""
    b, h, hk, s = 2, 4, 2, 200
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    vecs = _random_bands(cuda, True, 2, b, h, s)
    _sparse_kernels_vs_plain(q, k, v, do, True, dict(
        flashmask_vecs=vecs, flashmask_mode="causal_2"), softcap=30.0)
    bm = (torch.rand(1, 1, 2, 2, generator=cuda, device="cuda") < 0.7
          ).to(torch.int32)
    bm[0, 0, 0, 0] = 1
    _sparse_kernels_vs_plain(q, k, v, do, False,
                             dict(block_mask=(bm, 128, 128)), softcap=30.0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(200, 456), (456, 200)])
def test_masked_bwd_causal_sq_ne_sk(cuda, sq, sk, d):
    """Causal with sq != sk (the diagonal aligned bottom right; with sq >
    sk the first rows see no key) under a FlashMask and a block mask: the
    forward and the backward against their plain versions."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common
    b, h, hk = 2, 4, 2
    q, do = (torch.randn(b, h, sq, d, generator=cuda, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=cuda, device="cuda")
            .bfloat16() for _ in range(2))
    bm = (torch.rand(b, 1, -(-sq // 64), -(-sk // 128), generator=cuda,
                     device="cuda") < 0.7).to(torch.int32)
    for masks in (dict(flashmask_vecs=_random_bands(cuda, True, 1, b, h, sk),
                       flashmask_mode="causal_1"),
                  dict(block_mask=(bm, 64, 128))):
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        mask = common.dense_keep_mask(sq, sk, h, **masks)
        out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw,
                                           **masks)
        ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True,
                                             mask=mask, **kw)
        got = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw, **masks)
        want = bwd.attention_bwd_ref(q, k, v, out, lse, do, mask=mask, **kw)
        torch.cuda.synchronize()
        assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() \
            + 1e-3
        finite = torch.isfinite(ref_lse)
        assert torch.equal(finite, torch.isfinite(lse))
        if finite.any():  # with sq > sk a FlashMask may leave no row a key
            assert _err(lse[finite], ref_lse[finite]) <= 1e-3
        for g, w in zip(got, want):
            assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() \
                + 1e-4


def test_blocksparse_bwd_is_deterministic(cuda):
    """Two backward passes through BS's BigBird-like pattern (granularity
    256) give bitwise equal dq, dk and dv."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        blocksparse_attention
    b, h, s, d = 2, 4, 1024, 64
    q, k, v, do = _sparse_case(cuda, b, h, h, s, d)
    bm = _bigbird(cuda, b, s, 256)
    runs = []
    for _ in range(2):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = blocksparse_attention(*ins, bm, block_size=256)
        runs.append(torch.autograd.grad(out, ins, do))
    assert all(torch.equal(a, c) for a, c in zip(*runs))


def _masked_bwd_launches(q, k, v, out, lse, do, causal, masks, grads):
    """The pre-pass and both masked kernels into ``grads`` (dq, dk, dv)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common
    b, h, s, d = q.shape
    kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0,
              masks=common.KernelMasks(b, h, s, s, **masks))
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    bwd.flash_bwd_dkv(qs, k, v, do, lse, delta, *grads, **kw)
    bwd.flash_bwd_dq(qs, k, v, do, lse, delta, *grads, **kw)


def _masked_fwd_launches(q, k, v, causal, masks, outs):
    """The masked forward into ``outs`` (out, lse)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import common
    b, h, s, d = q.shape
    fwd.launch_flash_fwd(q, k, v, *outs, sm_scale=d ** -0.5, causal=causal,
                         softcap=0.0,
                         masks=common.KernelMasks(b, h, s, s, **masks))


@pytest.mark.parametrize("kernel", ["bwd", "fwd"])
@pytest.mark.parametrize("mask", ["document", "bigbird"])
def test_masked_bwd_in_a_cuda_graph(cuda, mask, kernel):
    """The masked backward, or the masked forward (a causal document mask
    at d 128 with GQA, or BS's pattern at granularity 256 and d 64),
    captured in a CUDA graph and replayed after dO (backward) or q
    (forward) was changed in place: bitwise equal to the eager launches on
    the new input (the scheduler's counter is cleared by a memset inside
    the graph)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        causal_document_mask)
    if mask == "document":
        b, h, hk, s, d, causal = 2, 8, 2, 1024, 128, True
        doc = (torch.arange(s, device="cuda") // 200)[None].expand(b, s)
        masks = dict(flashmask_vecs=causal_document_mask(doc).movedim(-1, 2),
                     flashmask_mode="causal_1")
    else:
        b, h, hk, s, d, causal = 2, 4, 4, 1024, 64, False
        masks = dict(block_mask=(_bigbird(cuda, b, s, 256), 256, 256))
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    out, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5,
                                       causal=causal, need_lse=True, **masks)
    if kernel == "bwd":
        changed = do = do.contiguous()
        got = [torch.empty_like(t) for t in (q, k, v)]
        eager = [torch.full_like(t, float("nan")) for t in got]

        def launch(into):
            _masked_bwd_launches(q, k, v, out, lse, do, causal, masks, into)
    else:
        changed = q = q.contiguous()
        got = [torch.empty_like(out), torch.empty_like(lse)]
        eager = [torch.full_like(t, float("nan")) for t in got]

        def launch(into):
            _masked_fwd_launches(q, k, v, causal, masks, into)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(got)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch(got)
    changed.copy_(torch.randn(changed.shape, generator=cuda, device="cuda"))
    graph.replay()
    launch(eager)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, eager))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,h,hk,d", [(1000, 1000, 8, 2, 128),
                                          (300, 700, 4, 4, 64),
                                          (700, 300, 8, 2, 64),
                                          (257, 1100, 8, 1, 128)])
def test_reduced_scores_match_plain(cuda, sq, sk, h, hk, d, causal):
    """The kernel against its plain version, whose q . k is an fp32 product
    of the same bf16 values summed in another order: 1e-4 of the largest
    score; and bitwise equal across two launches. GQA groups 1, 4 and 8,
    d 64 and 128, sq != sk both ways (causal with sq < sk: keys no row sees
    get 0), ragged tiles of rows and keys."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        reduced_scores as rs)
    b = 2
    q = torch.randn(b, sq, h, d, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(b, sk, hk, d, generator=cuda, device="cuda")
            .bfloat16().transpose(1, 2) for _ in range(2))
    q = q.transpose(1, 2)
    _, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5,
                                     causal=causal)
    before = rs.calc_reduced_attn_scores.launches
    got = rs.calc_reduced_attn_scores(q, k, lse, causal=causal)
    again = rs.calc_reduced_attn_scores(q, k, lse, causal=causal)
    want = rs.reduced_scores_ref(q, k, lse, sm_scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert rs.calc_reduced_attn_scores.launches == before + 2
    assert torch.equal(got, again)
    assert _err(got, want) <= 1e-4 * want.abs().max().item()


def test_reduced_scores_in_a_cuda_graph(cuda):
    """The reduced scores (GQA, d 128, causal) captured in a CUDA graph and
    replayed after q was changed in place: bitwise equal to an eager launch
    on the new q."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        reduced_scores as rs)
    b, h, hk, s, d = 1, 8, 2, 1024, 128
    q, k, v, _ = _sparse_case(cuda, b, h, hk, s, d)
    q = q.contiguous()
    _, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5, causal=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    q.copy_(torch.randn(q.shape, generator=cuda, device="cuda"))
    graph.replay()
    eager = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)


# ------------------------------------------------ the decode steps as graphs


def _tiny_llama():
    """A 2-layer bf16 Llama on the card (hidden 256, 4/2 heads of 64)."""
    from xhy_flash_attention_tpu_torch import (GPTLMHeadModel,
                                               llama_config_to_gpt_config)
    hf = types.SimpleNamespace(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5)
    return GPTLMHeadModel(
        llama_config_to_gpt_config(hf, torch.bfloat16), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))


@pytest.mark.parametrize("cache", [None, torch.int8], ids=["bf16", "int8"])
def test_decode_cuda_graph_matches_uncaptured(cuda, cache):
    """decode() replaying its step as a CUDA graph against the same step
    run uncaptured: a replay runs the kernels an eager step launches, in its
    order, so the tokens are equal and the logits bitwise equal."""
    from xhy_flash_attention_tpu_torch import decode
    from xhy_flash_attention_tpu_torch.utils.generation import CUDAGraphStep
    model = _tiny_llama()
    ids = torch.randint(0, 512, (2, 40), generator=cuda, device="cuda")
    replays = CUDAGraphStep.replays
    seq, scores = decode(model, ids, 56, return_scores=True, cache_dtype=cache)
    assert CUDAGraphStep.replays == replays + 15
    want_seq, want = decode(model, ids, 56, return_scores=True,
                            cache_dtype=cache, cuda_graph=False)
    assert CUDAGraphStep.replays == replays + 15
    assert torch.equal(seq, want_seq)
    assert torch.equal(scores, want)


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_engine_cuda_graph_matches_uncaptured(cuda, pages, spec):
    """The engine with its decode (or verify) step as a CUDA graph against
    the same engine uncaptured: 8 requests on 4 slots, equal tokens."""
    import numpy as np
    from xhy_flash_attention_tpu_torch.inference import (InferenceEngine,
                                                         Request)
    model = _tiny_llama()
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, int(rng.integers(5, 150))).astype(np.int32),
             int(rng.integers(4, 20))) for _ in range(8)]

    def run(graph):
        eng = InferenceEngine(model, num_layers=2, num_kv_heads=2,
                              head_dim=64, num_pages=40, page_size=64,
                              max_batch=4, max_pages_per_seq=4, dtype=pages,
                              speculate_len=spec, cuda_graph=graph)
        for i, (p, n) in enumerate(reqs):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
        return eng.run(), eng

    got, eng = run(True)
    want, ref = run(False)
    assert got == want and eng.stats == ref.stats
    assert list(eng._steps) == [1 + spec]
    assert eng._steps[1 + spec].graph is not None
    assert ref._steps[1 + spec].graph is None


def test_decode_step_replay_launches_what_an_eager_step_does(cuda):
    """The kernel wrappers count a launch while the step is captured, once
    for every replay: capturing a step counts what an eager step counts
    (2 layers: 5 norms, 2 decode launches), and replays count nothing."""
    from xhy_flash_attention_tpu_torch.utils.generation import (CUDAGraphStep,
                                                                DecodeStep)
    model = _tiny_llama()
    ids = torch.randint(0, 512, (2, 40), generator=cuda, device="cuda")
    steps = []
    for graph in (False, True):
        step = DecodeStep(model, 2, 64, cuda_graph=graph)
        with torch.inference_mode():
            model(ids, kv_caches=list(step.caches), seqlen_offset=0)
        step.offset.fill_(40)
        step.tokens.fill_(3)
        steps.append(step)
    eager, graphed = steps

    def launches():
        return (ln.ln_fwd.launches, dk.flash_decode.launches)

    before = launches()
    want = eager()
    per_step = tuple(a - b for a, b in zip(launches(), before))
    assert per_step == (5, 2)
    before = launches()
    got = graphed()  # run once on a side stream, then captured
    assert tuple(a - b for a, b in zip(launches(), before)) == tuple(
        2 * n for n in per_step)
    assert torch.equal(got, want)
    before, replays = launches(), CUDAGraphStep.replays
    for _ in range(3):
        eager()
        graphed()
    assert launches() == tuple(a + 3 * n for a, n in zip(before, per_step))
    assert CUDAGraphStep.replays == replays + 3
    torch.cuda.synchronize()
    assert torch.equal(graphed.offset, eager.offset)
    assert torch.equal(graphed(), eager())
    for (gk, gv), (ek, ev) in zip(graphed.caches, eager.caches):
        assert torch.equal(gk, ek) and torch.equal(gv, ev)


def test_cuda_graph_step_raises_when_capture_fails(cuda):
    """A step that reads a device value on the host cannot be captured:
    the error is raised, and no eager call stands in for the graph."""
    from xhy_flash_attention_tpu_torch.utils.generation import CUDAGraphStep
    x = torch.ones(4, device="cuda")
    step = CUDAGraphStep(lambda: x * x.sum().item(), graph=True)
    with pytest.raises(RuntimeError):
        step()
    assert step.out is None
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.full((4,), 2.0, device="cuda"))


# ---- sliding windows, segment ids and positions (the masked kernels)

def _flag_kernels_vs_plain(q, k, v, do, causal, window=(-1, -1), **flags):
    """The forward and both backward kernels under a window and any of the
    segment, position, FlashMask and block-mask flags, against the plain
    versions with the dense mask (fwd.build_masks, the entry's own
    resolution of the flags), as `_sparse_kernels_vs_plain`: tolerances,
    launches, a direct launch into NaN-filled buffers bit for bit, and the
    tiles each kernel counts against fwd.py's and bwd.py's mirrors."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    eff, kmasks = fwd.build_masks(b, h, sq, sk, causal, window, **flags)
    assert kmasks.active
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    mask = kmasks.keep(h, q.device)
    before = (fwd.flash_attention_fwd.launches, bwd.flash_bwd_dkv.launches,
              bwd.flash_bwd_dq.launches)
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw,
                                       masks=kmasks)
    ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=mask,
                                         **kw)
    got = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw, masks=kmasks)
    want = bwd.attention_bwd_ref(q, k, v, out, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    assert (fwd.flash_attention_fwd.launches, bwd.flash_bwd_dkv.launches,
            bwd.flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert _err(lse[finite], ref_lse[finite]) <= 1e-3
    assert not out[~finite].float().abs().any()
    for g, w in zip(got, want):
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    out2, lse2 = (torch.full_like(t, float("nan")) for t in (out, lse))
    fwd_counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fwd.launch_flash_fwd(q, k, v, out2, lse2, masks=kmasks,
                         tile_counts=fwd_counts, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    plans = (fwd.fwd_masked_tile_plan(kmasks, b, h, sq, sk, eff),
             bwd.bwd_masked_dkv_tile_plan(kmasks, b, h, hk, sq, sk, eff),
             bwd.bwd_masked_dq_tile_plan(kmasks, b, h, hk, sq, sk, eff, d))
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    direct = [torch.full_like(t, float("nan")) for t in got]
    counted = [fwd_counts[1:].tolist()]
    for fn in (bwd.flash_bwd_dkv, bwd.flash_bwd_dq):
        counts = torch.zeros(3, dtype=torch.int32, device="cuda")
        fn(qs, k, v, do, lse, delta, *direct, masks=kmasks,
           tile_counts=counts, **kw)
        counted.append(counts[1:].tolist())
    assert all(torch.equal(a, c) for a, c in zip(direct, got))
    assert counted == [
        [len(tiles), sum(1 for e in tiles if e[-2])]
        for tiles in ([e for es in plan.values() for e in es]
                      for plan in plans)]
    return out, got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, (100, -1)),
                                           (False, (100, -1)),
                                           (False, (-1, 70)),
                                           (False, (130, 30)),
                                           (True, (0, 0))])
@pytest.mark.parametrize("sq,sk", [(300, 300), (200, 500), (500, 200)])
def test_window_kernels_match_plain(cuda, sq, sk, causal, window, d):
    """Sliding windows through the masked kernels: causal with a left
    bound, left only, right only, both, the diagonal alone (0, 0); sq ==
    sk, sq < sk and sq > sk (rows with no key: out 0, LSE +inf); GQA (h 8
    over hk 2); ragged lengths."""
    b, h, hk = 2, 8, 2
    q, do = (torch.randn(b, sq, h, d, generator=cuda, device="cuda")
             .bfloat16().transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, sk, hk, d, generator=cuda, device="cuda")
            .bfloat16().transpose(1, 2) for _ in range(2))
    _flag_kernels_vs_plain(q, k, v, do, causal, window)


def _ids(cuda, b, s, n, monotone, pad=0):
    """(b, s) int32 segment ids in [1, n]: sorted (packed documents) or
    drawn independently per token; the last ``pad`` tokens 0 (padding)."""
    ids = torch.randint(1, n + 1, (b, s), generator=cuda, device="cuda")
    if monotone:
        ids = ids.sort(-1).values
    if pad:
        ids[:, s - pad:] = 0
    return ids.to(torch.int32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_segment_kernels_match_plain(cuda, causal, monotone, d):
    """Segment ids, sorted (packed documents) and arbitrary (the stats are
    only conservative then), with a padded tail of id 0 on the queries and
    another on the keys; s 333."""
    b, h, hk, s = 2, 4, 2, 333
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    _flag_kernels_vs_plain(
        q, k, v, do, causal,
        q_segment_ids=_ids(cuda, b, s, 5, monotone, pad=40),
        kv_segment_ids=_ids(cuda, b, s, 5, monotone, pad=17))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [(-1, -1), (47, -1)])
def test_varlen_kernels_with_decoupled_packings(cuda, window, d):
    """Varlen with cu_seqlens_q != cu_seqlens_k through the public entry:
    each sequence aligned to the bottom right by positions (queries of a
    sequence with fewer keys than queries see none), causal, with and
    without a left window; forward and gradients against the plain
    versions through autograd; the tile counts of the direct launches."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import interface
    h, hk = 4, 2
    cu_q = torch.tensor([0, 100, 130, 400, 410], dtype=torch.int32,
                        device="cuda")
    cu_k = torch.tensor([0, 60, 250, 500, 530], dtype=torch.int32,
                        device="cuda")
    tq, tk = 420, 530  # 10 query tokens past cu_q[-1]
    q, do = (torch.randn(tq, h, d, generator=cuda, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(tk, hk, d, generator=cuda, device="cuda").bfloat16()
            for _ in range(2))
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = interface.flash_attn_varlen_func(
        *ins, cu_q, cu_k, 300, 250, causal=True, window_size=window,
        return_lse=True)
    grads = torch.autograd.grad(out, ins, do)
    seg_q = interface._segment_ids_from_cu_seqlens(cu_q, tq)[None]
    seg_k = interface._segment_ids_from_cu_seqlens(cu_k, tk)[None]
    lq, sq_ = interface._local_positions(cu_q, tq)
    lk, _ = interface._local_positions(cu_k, tk)
    off = ((cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1]))[sq_]
    flags = dict(q_segment_ids=seg_q, kv_segment_ids=seg_k,
                 q_positions=(lq + off)[None], kv_positions=lk[None])
    bhsd = [t[None].transpose(1, 2) for t in (q, k, v, do)]
    o2, g2 = _flag_kernels_vs_plain(*bhsd, True, window, **flags)
    torch.cuda.synchronize()
    assert torch.equal(out, o2.transpose(1, 2)[0])
    # the first 20 queries of sequence 2 (270 queries, 250 keys) and the 10
    # tokens past cu_seqlens_q[-1] see no key
    assert torch.isinf(lse[:, 130:150]).all() and torch.isinf(lse[:, 410:]).all()
    for g, w in zip(grads, g2):
        assert torch.equal(g, w.transpose(1, 2)[0])


@pytest.mark.parametrize("d", [64, 128])
def test_varlen_kvpacked_strided_views(cuda, d):
    """flash_attn_varlen_kvpacked_func reads kv (total, 2, hk, d) through
    the strided k and v views (a row stride of 2 hk d elements, TMA's
    16-byte alignment), forward and backward, against the same call on
    contiguous copies: bitwise equal; a second pass bitwise equal."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import interface
    h, hk, total = 8, 2, 700
    cu = torch.tensor([0, 128, 129, 400, 700], dtype=torch.int32,
                      device="cuda")
    q, do = (torch.randn(total, h, d, generator=cuda, device="cuda")
             .bfloat16() for _ in range(2))
    kv = torch.randn(total, 2, hk, d, generator=cuda, device="cuda").bfloat16()

    def run(packed):
        qi = q.detach().requires_grad_()
        kvi = kv.detach().clone().requires_grad_()
        if packed:
            out = interface.flash_attn_varlen_kvpacked_func(
                qi, kvi, cu, cu, 300, 300, causal=True)
            return out, torch.autograd.grad(out, (qi, kvi), do)
        ki, vi = kvi[:, 0].contiguous(), kvi[:, 1].contiguous()
        out = interface.flash_attn_varlen_func(qi, ki, vi, cu, cu, 300, 300,
                                               causal=True)
        return out, torch.autograd.grad(out, (qi, kvi), do)

    a, b_, c = run(True), run(True), run(False)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b_[0]) and torch.equal(a[0], c[0])
    for x, y, z in zip(a[1], b_[1], c[1]):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("combo", ["window+flashmask", "window+block",
                                   "segments+flashmask", "segments+block",
                                   "positions+flashmask", "positions+block",
                                   "window+segments+block"])
def test_flags_combine_with_sparse_masks(cuda, combo, d):
    """Every flag pair the JAX entry accepts, ANDed: a window, segment ids
    or positions (a causal window on positions shifted per batch) with a
    FlashMask (causal_2, one mask head per query head) or a block mask
    (granularity 64, straddling the 128-row and 128-key blocks)."""
    b, h, hk, s = 2, 4, 2, 320
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    flags, window = {}, (-1, -1)
    if "window" in combo:
        window = (90, 0)
    if "segments" in combo:
        flags.update(q_segment_ids=_ids(cuda, b, s, 3, True),
                     kv_segment_ids=_ids(cuda, b, s, 3, True))
    if "positions" in combo:
        pos = (torch.arange(s, device="cuda")[None] * 2
               + torch.tensor([[0], [7]], device="cuda")).to(torch.int32)
        flags.update(q_positions=pos, kv_positions=pos)
        window = (150, 0)
    if "flashmask" in combo:
        flags.update(flashmask_vecs=_random_bands(cuda, True, 2, b, h, s),
                     flashmask_mode="causal_2")
    if "block" in combo:
        bm = (torch.rand(b, 1, -(-s // 64), -(-s // 64), generator=cuda,
                         device="cuda") < 0.7).to(torch.int32)
        flags.update(block_mask=(bm, 64, 64))
    _flag_kernels_vs_plain(q, k, v, do, True, window, **flags)


def test_window_bwd_is_deterministic_and_graphable(cuda):
    """Two passes of a windowed GQA attention through the autograd entry
    give bitwise equal outputs and gradients; the forward replays in a CUDA
    graph bitwise equal to an eager call."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import interface
    b, h, hk, s, d = 1, 8, 2, 1100, 128
    q, k, v, do = _sparse_case(cuda, b, h, hk, s, d)
    runs = []
    for _ in range(2):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = interface.flash_attention(*ins, causal=True,
                                        window_size=(255, 0))
        runs.append((out,) + torch.autograd.grad(out, ins, do))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    with torch.no_grad():
        eager = interface.flash_attention(q, k, v, causal=True,
                                          window_size=(255, 0))
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            interface.flash_attention(q, k, v, causal=True,
                                      window_size=(255, 0))
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            captured = interface.flash_attention(q, k, v, causal=True,
                                                 window_size=(255, 0))
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


# ---- attention bias and dbias (the bias instantiations of #1, #2, #3 and
# the dbias kernel)

def _bias_shape(kind, b, h, sq, sk):
    return {"2d": (sq, sk), "3d": (b, sq, sk), "1h": (1, h, sq, sk),
            "b1": (b, 1, sq, sk), "bh": (b, h, sq, sk)}[kind]


def _bias_inputs(cuda, kind, b, h, hk, sq, sk, d, dtype=torch.float32):
    q, do = (torch.randn(b, sq, h, d, generator=cuda, device="cuda")
             .bfloat16().transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, sk, hk, d, generator=cuda, device="cuda")
            .bfloat16().transpose(1, 2) for _ in range(2))
    bias = 2 * torch.randn(_bias_shape(kind, b, h, sq, sk), generator=cuda,
                           device="cuda")
    return q, k, v, do, bias.to(dtype)


def _bias_kernels_vs_plain(q, k, v, do, bias, causal, softcap=0.0,
                           window=(-1, -1), **flags):
    """The forward, the dK/dV and dQ kernels and the dbias kernel with a
    bias, against the plain versions on the same inputs: one launch each;
    out within one bf16 unit of its largest entry + 1e-3, the LSE within
    1e-3 where finite (the same rows +inf), dq/dk/dv within four bf16
    units of their largest entry + 1e-4 (as the kernels without a bias),
    dbias in the bias's shape and dtype within 1e-3 (fp32; bf16: one bf16
    unit) of its largest entry + 1e-4 (fp32 sums in another order, exp2 on
    the SFU); a second backward bitwise equal. Returns the gradients."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, sq, d = q.shape
    sk = k.shape[2]
    eff, kmasks = fwd.build_masks(b, h, sq, sk, causal, window, **flags)
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=softcap)
    mask = kmasks.keep(h, q.device)
    bias4 = fwd.bias_view(bias, b, h, sq, sk)
    count = lambda: (fwd.flash_attention_fwd.launches,  # noqa: E731
                     bwd.flash_bwd_prep.launches, bwd.flash_bwd_dkv.launches,
                     bwd.flash_bwd_dq.launches, bwd.flash_bwd_dbias.launches)
    before = count()
    out, lse = fwd.flash_attention_fwd(q, k, v, bias, need_lse=True,
                                       masks=kmasks, **kw)
    got = bwd.flash_attention_bwd(q, k, v, out, lse, do, bias, masks=kmasks,
                                  **kw)
    torch.cuda.synchronize()
    assert count() == tuple(n + 1 for n in before)
    ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=mask,
                                         bias=bias4, **kw)
    want = bwd.attention_bwd_ref(q, k, v, out, lse, do, mask=mask,
                                 bias=bias4, **kw)
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert _err(lse[finite], ref_lse[finite]) <= 1e-3
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    dbias, want_db = got[3], want[3].reshape(bias.shape)
    assert dbias.shape == bias.shape and dbias.dtype == bias.dtype
    rel = BF16_ULP if bias.dtype == torch.bfloat16 else 1e-3
    assert _err(dbias, want_db) <= rel * want_db.float().abs().max().item() \
        + 1e-4
    again = bwd.flash_attention_bwd(q, k, v, out, lse, do, bias,
                                    masks=kmasks, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    return got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["2d", "3d", "1h", "b1", "bh"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333)])
def test_bias_kernels_match_plain(cuda, sq, sk, kind, causal, d):
    """Every bias kind through the dense instantiations (causal and full),
    GQA (h 4 over hk 2), sk even (the bias read in place) and odd (copied
    once into rows of even length), sq != sk."""
    q, k, v, do, bias = _bias_inputs(cuda, kind, 2, 4, 2, sq, sk, d)
    _bias_kernels_vs_plain(q, k, v, do, bias, causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["2d", "3d", "1h", "b1", "bh"])
@pytest.mark.parametrize("flag", ["window", "segments", "positions"])
def test_bias_masked_kernels_match_plain(cuda, flag, kind, d):
    """A bias through the masked instantiations: a causal window (100, 0),
    segment ids with a padded tail, q/kv positions (decoupled packings);
    s 333."""
    b, h, hk, s = 2, 4, 2, 333
    q, k, v, do, bias = _bias_inputs(cuda, kind, b, h, hk, s, s, d)
    flags, window = {}, (-1, -1)
    if flag == "window":
        window = (100, -1)
    elif flag == "segments":
        flags = dict(q_segment_ids=_ids(cuda, b, s, 4, True, pad=30),
                     kv_segment_ids=_ids(cuda, b, s, 4, True, pad=11))
    else:
        pos = torch.arange(s, device="cuda", dtype=torch.int32)
        flags = dict(q_positions=(pos // 2)[None].repeat(b, 1),
                     kv_positions=pos[None].repeat(b, 1))
    _bias_kernels_vs_plain(q, k, v, do, bias, True, window=window, **flags)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["2d", "1h", "bh"])
def test_bias_softcap_gqa_bf16(cuda, kind, d):
    """A bf16 bias with softcap (the bias after it) and a GQA group of 4:
    dbias of a head-broadcast bias summed over the group's heads and the
    batch."""
    q, k, v, do, bias = _bias_inputs(cuda, kind, 2, 8, 2, 300, 300, d,
                                     torch.bfloat16)
    _bias_kernels_vs_plain(q, k, v, do, bias, True, softcap=20.0)


def test_bias_only_gradient_and_guard(cuda):
    """Through flash_attention's autograd: with only the bias needing a
    gradient, the backward launches the pre-pass and the dbias kernel and
    neither dK/dV nor dQ; a bias that is a view at the start of a larger
    buffer whose tail is NaN gives the same bits as a clean copy (no
    element past its last is read into a result)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, interface
    b, h, hk, s, d = 2, 4, 2, 384, 128
    q, k, v, do, bias = _bias_inputs(cuda, "b1", b, h, hk, s, s, d)
    buf = torch.full((bias.numel() + 4096,), float("nan"), device="cuda")
    guarded = buf[:bias.numel()].view(bias.shape)
    guarded.copy_(bias)
    runs = []
    for t in (bias, guarded):
        bg = t.detach().requires_grad_()
        before = (bwd.flash_bwd_prep.launches, bwd.flash_bwd_dkv.launches,
                  bwd.flash_bwd_dq.launches, bwd.flash_bwd_dbias.launches)
        out = interface.flash_attention(q, k, v, bg, causal=True)
        (db,) = torch.autograd.grad(out, (bg,), do)
        torch.cuda.synchronize()
        assert (bwd.flash_bwd_prep.launches, bwd.flash_bwd_dkv.launches,
                bwd.flash_bwd_dq.launches, bwd.flash_bwd_dbias.launches) == (
            before[0] + 1, before[1], before[2], before[3] + 1)
        runs.append((out, db))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    assert bool(torch.isfinite(runs[0][1]).all())


# ---- the fp8 (e4m3) forward: the e4m3 instantiation of flash_fwd.cu

FP8_SHAPES = [  # b, sq, sk, h, hk, causal
    (2, 128, 128, 3, 3, False), (2, 257, 257, 2, 2, False),
    (2, 113, 203, 2, 2, True), (2, 256, 256, 8, 2, True),
    (1, 1000, 1000, 4, 1, True), (2, 300, 77, 2, 2, True)]


def _fp8_inputs(gen, b, sq, sk, h, hk, d):
    """Quantized q/k/v (b, s, ·, d) with per-head magnitudes spanning ~30x
    (the JAX test's) and their (b, hk) descales."""
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_fp8_per_head

    def mk(s, nh):
        x = torch.randn(b, s, nh, d, generator=gen, device="cuda")
        mags = 0.2 * (1 + torch.arange(nh, device="cuda") * 29.0
                      / max(nh - 1, 1))
        return x * mags[None, None, :, None]
    (q8, qd), (k8, kd), (v8, vd) = (quantize_fp8_per_head(mk(sq, h), hk),
                                    quantize_fp8_per_head(mk(sk, hk)),
                                    quantize_fp8_per_head(mk(sk, hk)))
    return q8, k8, v8, qd, kd, vd


def _fp8_contract(out, lse, q8, k8, v8, qd, kd, vd, **kw):
    """The JAX fp8 test's contract on the dequantized inputs: out and the
    LSE within twice the bf16 reorder-ops baseline's error against fp32
    (atol 1e-4 and 1e-3)."""
    hk = k8.shape[2]

    def deq(x8, dsc):
        b, s, h, d = x8.shape
        return (x8.float().view(b, s, hk, h // hk, d)
                * dsc[:, None, :, None, None]).view(b, s, h, d)
    qf, kf, vf = deq(q8, qd), deq(k8, kd), deq(v8, vd)
    ref, _ = attention_ref(qf, kf, vf, **kw)
    lp, _ = attention_ref(qf.bfloat16(), kf.bfloat16(), vf.bfloat16(),
                          upcast=False, reorder_ops=True, **kw)
    assert _err(out, ref) <= 2 * _err(lp, ref) + 1e-4
    if lse is None:
        return
    g = q8.shape[2] // hk

    def lse_of(qx, kx):
        s = torch.einsum("bshd,bthd->bhst", qx.float(),
                         kx.float().repeat_interleave(g, dim=2))
        s = s * q8.shape[-1] ** -0.5
        if kw.get("softcap", 0.0) > 0:
            s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
        sq, sk = s.shape[-2:]
        left, right = kw.get("window_size", (-1, -1))
        if kw.get("causal"):
            right = 0
        rows = torch.arange(sq, device="cuda")[:, None] + sk - sq
        cols = torch.arange(sk, device="cuda")[None, :]
        keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
        if right >= 0:
            keep &= cols <= rows + right
        if left >= 0:
            keep &= cols >= rows - left
        return torch.logsumexp(s.masked_fill(~keep, -float("inf")), -1)
    ref_l, lp_l = lse_of(qf, kf), lse_of(qf.bfloat16(), kf.bfloat16())
    fin = torch.isfinite(ref_l)
    assert torch.equal(fin, torch.isfinite(lse))
    assert _err(lse[fin], ref_l[fin]) <= 2 * _err(lp_l[fin], ref_l[fin]) + 1e-3


def _fp8_accumulation(out, lse, ref, ref_lse, x):
    """out and each row's LSE against the plain version within the limits
    on the e4m3 wgmma's accumulation error (reference.fp8_ref_errors)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import reference
    eo, el = reference.fp8_ref_errors(out, lse, ref, ref_lse, x[0], x[1],
                                      x[3], x[4], x[5], x[0].shape[-1] ** -0.5)
    assert eo <= reference.FP8_OUT_TOL and el <= reference.FP8_LSE_TOL, \
        (eo, el)


def _fp8_run(q8, k8, v8, qd, kd, vd, **kw):
    """(out, lse) of the kernel (one launch checked) and of the plain version
    on the same card tensors."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_fp8_ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q8, k8, v8))
    before = fwd.flash_fwd_fp8.launches
    out, lse = fwd.flash_fwd_fp8(qt, kt, vt, qd, kd, vd, sm_scale=q8.shape[-1]
                                 ** -0.5, **kw)
    torch.cuda.synchronize()
    assert fwd.flash_fwd_fp8.launches == before + 1
    ref, ref_lse = attention_fp8_ref(qt, kt, vt, qd, kd, vd,
                                     sm_scale=q8.shape[-1] ** -0.5, **kw)
    return out.transpose(1, 2), lse, ref.transpose(1, 2), ref_lse


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", FP8_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_fp8_kernel_matches_plain(cuda, shape, d):
    b, sq, sk, h, hk, causal = shape
    x = _fp8_inputs(cuda, b, sq, sk, h, hk, d)
    out, lse, ref, ref_lse = _fp8_run(*x, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == (b, sq, h, d)
    _fp8_contract(out, lse, *x, causal=causal)
    # the plain version repeats the kernel's arithmetic: two bf16 units of
    # the largest output (both round the output; P and the sums in another
    # order); out and each row's LSE within the limits on the e4m3 wgmma's
    # accumulation error
    assert _err(out, ref) <= 2 * BF16_ULP * ref.float().abs().max().item()
    _fp8_accumulation(out, lse, ref, ref_lse, x)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [dict(window_size=(64, 0)),
                                dict(window_size=(100, 30)),
                                dict(softcap=30.0, causal=True)],
                         ids=["window", "window-both", "softcap"])
def test_fp8_window_softcap(cuda, kw, d):
    x = _fp8_inputs(cuda, 1, 384, 384, 4, 2, d)
    out, lse, ref, ref_lse = _fp8_run(*x, **kw)
    _fp8_contract(out, lse, *x, **kw)
    assert _err(out, ref) <= 2 * BF16_ULP * ref.float().abs().max().item()
    _fp8_accumulation(out, lse, ref, ref_lse, x)


@pytest.mark.parametrize("d", [64, 128])
def test_fp8_kernel_is_bitwise_repeatable(cuda, d):
    x = _fp8_inputs(cuda, 2, 1024, 1024, 8, 2, d)
    first = _fp8_run(*x, causal=True)[:2]
    second = _fp8_run(*x, causal=True)[:2]
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_fp8_default_descale_and_no_lse(cuda):
    q8, k8, v8, _, _, _ = _fp8_inputs(cuda, 1, 256, 256, 2, 2, 128)
    ones = torch.ones(1, 2, device="cuda")
    from xhy_flash_attention_tpu_torch import flash_attn_fp8_func
    a, la = flash_attn_fp8_func(q8, k8, v8, causal=True, return_lse=True)
    c, lc = flash_attn_fp8_func(q8, k8, v8, ones, ones, ones, causal=True,
                                return_lse=True)
    e = flash_attn_fp8_func(q8, k8, v8, causal=True)
    assert torch.equal(a, c) and torch.equal(la, lc) and torch.equal(a, e)


def test_fp8_unaligned_strides_raise(cuda):
    """The e4m3 tensor maps need 16-byte pointers and strides."""
    q8, k8, v8, qd, kd, vd = _fp8_inputs(cuda, 1, 128, 128, 2, 2, 64)
    wide = torch.zeros(1, 128, 2, 72, device="cuda").to(torch.float8_e4m3fn)
    wide[..., :64] = q8
    from xhy_flash_attention_tpu_torch import flash_attn_fp8_func
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_attn_fp8_func(wide[..., :64], k8, v8, qd, kd, vd)
    flat = torch.zeros(q8.numel() + 1, device="cuda").to(torch.float8_e4m3fn)
    shifted = flat[1:].view(q8.shape)
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_attn_fp8_func(shifted, k8, v8, qd, kd, vd)


# ---- fp32: csrc/flash_fp32.cu (#1/#2/#3, #5/#6 through strides, the
# prefill regime of #10/#11) and the fp32 decode paths (#4, #9, #10/#11)

def _attention64(q, k, v, do=None, *, causal, window=(-1, -1), softcap=0.0):
    """float64 attention on (b, h, s, d) tensors: (out, lse) and with
    ``do`` also (dq, dk, dv); the window bottom-right aligned, causal as
    right bound 0."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        window_keep)
    ins = [t.detach().double().requires_grad_(do is not None)
           for t in (q, k, v)]
    qd, kd, vd = ins
    g = qd.shape[1] // kd.shape[1]
    sq, sk, d = qd.shape[2], kd.shape[2], qd.shape[3]
    s = (qd * d ** -0.5) @ kd.repeat_interleave(g, 1).transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    left, right = window
    keep = window_keep(sq, sk, (left, 0 if causal else right), q.device)
    s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = torch.nan_to_num(torch.softmax(s, -1)) @ vd.repeat_interleave(g, 1)
    if do is None:
        return out, lse
    return (out, lse) + torch.autograd.grad(out, ins, do.double())


def _fp32_case(cuda, b, h, hk, sq, sk, d):
    shapes = ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d))
    return [torch.randn(s, generator=cuda, device="cuda").transpose(1, 2)
            for s in shapes]


def _fp32_contract(name, got, plain, want):
    """The JAX contract for fp32 with its reference in float64: the
    kernel's error at most twice the fp32 plain version's, plus 1e-4."""
    e, e_lp = _err(got, want), _err(plain, want)
    assert e <= 2 * e_lp + 1e-4, (name, e, e_lp)


FP32_CASES = [  # sq, sk, causal, window, softcap
    (113, 203, True, (-1, -1), 0.0),
    (203, 113, False, (-1, -1), 30.0),
    (257, 257, True, (-1, -1), 0.0),
    (257, 257, False, (100, 20), 0.0),
    (257, 257, True, (64, -1), 20.0),
    (1100, 1100, True, (-1, -1), 0.0),  # the rings wrap many times
    # ~100 key tiles a row: a P V sum kept on the tensor cores across the
    # tiles would drift (they truncate their sums)
    (257, 4100, False, (-1, -1), 0.0),
]


@pytest.mark.parametrize("hk", [8, 2])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window,softcap", FP32_CASES)
def test_fp32_kernels_meet_the_contract(cuda, sq, sk, causal, window, softcap,
                                        d, hk):
    """fp32 forward, pre-pass, dK/dV and dQ through the public wrappers,
    one launch each; out, LSE and every gradient against float64 within
    twice the fp32 plain versions' error plus 1e-4."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h = 2, 8
    q, k, v, do = _fp32_case(cuda, b, h, hk, sq, sk, d)
    kw = dict(sm_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap)
    counts = (fwd.flash_fwd_fp32, bwd.flash_bwd_prep, bwd.flash_bwd_dkv_fp32,
              bwd.flash_bwd_dq_fp32, fwd.flash_attention_fwd,
              bwd.flash_bwd_dkv)
    before = [c.launches for c in counts]
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == \
        [1, 1, 1, 1, 0, 0]
    assert out.dtype == torch.float32 and all(
        g.dtype == torch.float32 for g in grads)
    cpu = [t.cpu() for t in (q, k, v, do)]
    pk = dict(kw)
    pk["causal"], masks = fwd.build_masks(b, h, sq, sk, causal, window)
    del pk["window_size"]
    keep = masks.keep(h)
    p_out, p_lse = fwd.attention_fwd_ref(*cpu[:3], need_lse=True, mask=keep,
                                         **pk)
    p_grads = bwd.attention_bwd_ref(*cpu[:3], p_out, p_lse, cpu[3],
                                    mask=keep, **pk)
    want = _attention64(*cpu, causal=causal, window=window, softcap=softcap)
    seen = torch.isfinite(want[1])
    _fp32_contract("out", out.cpu(), p_out, want[0])
    _fp32_contract("lse", lse.cpu()[seen], p_lse[seen], want[1][seen])
    for name, g, pg, w in zip(("dq", "dk", "dv"), grads, p_grads, want[2:]):
        _fp32_contract(name, g.cpu(), pg, w)


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_backward_is_bitwise_deterministic(cuda, d):
    """Three fp32 backward passes through flash_attn_func (GQA 8 over 2,
    causal): dq, dk and dv bitwise equal."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import flash_attn_func
    b, s, h, hk = 2, 700, 8, 2
    q, k, v, do = (t.transpose(1, 2).contiguous()
                   for t in _fp32_case(cuda, b, h, hk, s, s, d))
    runs = []
    for _ in range(3):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = flash_attn_func(*ins, causal=True)
        runs.append(torch.autograd.grad(out, ins, do))
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))


@pytest.mark.parametrize("s", [257, 640])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_packed_qkv_attention(cuda, causal, s):
    """#5 / #6 in fp32: packed_qkv_attention on a (b, s, 3 h d) Wqkv output
    (h d = 1024), forward and the packed dqkv, against float64 under the
    contract; one #5 and one #6 launch."""
    b, h, d = 2, 16, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=cuda, device="cuda")
    do = torch.randn(b, s, h * d, generator=cuda, device="cuda")
    before = (fh.fused_heads_fwd.launches, fh.fused_heads_bwd.launches)
    x = qkv.clone().requires_grad_()
    out = fh.packed_qkv_attention(x, num_heads=h, num_heads_kv=h, head_dim=d,
                                  causal=causal)
    (dqkv,) = torch.autograd.grad(out, (x,), do)
    torch.cuda.synchronize()
    assert (fh.fused_heads_fwd.launches, fh.fused_heads_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               .transpose(1, 2).cpu() for i in range(3))
    dot = do.view(b, s, h, d).transpose(1, 2).cpu()
    want = _attention64(q, k, v, dot, causal=causal)
    xp = qkv.cpu().requires_grad_()
    p_out = fh.packed_qkv_attention(xp, num_heads=h, num_heads_kv=h,
                                    head_dim=d, causal=causal)
    (p_dqkv,) = torch.autograd.grad(p_out, (xp,), do.cpu())
    flat = want[0].transpose(1, 2).reshape(b, s, h * d)
    _fp32_contract("out", out.detach().cpu(), p_out.detach(), flat)
    wgrad = torch.cat([g.transpose(1, 2).reshape(b, s, h * d)
                       for g in want[2:]], -1)
    _fp32_contract("dqkv", dqkv.cpu(), p_dqkv, wgrad)


@pytest.mark.parametrize("d,npp,ps,entry", [(128, 8, 64, "chunked"),
                                            (64, 8, 64, "page"),
                                            (64, 2, 512, "page"),
                                            # pages below the forward's key
                                            # tile: cp.async, not TMA
                                            (64, 16, 32, "page")])
@pytest.mark.parametrize("sq,window,softcap", [(1, -1, 0.0), (3, 100, 0.0),
                                               (37, 200, 30.0),
                                               (512, -1, 0.0)])
def test_fp32_paged_matches_plain(cuda, sq, window, softcap, d, npp, ps,
                                  entry):
    """#10 / #11 on fp32 pages: the decode regime (sq * g <= 16) and the
    prefill regime (csrc/flash_fp32.cu's paged forward), ragged lengths
    and an empty slot, against the plain version within 1e-5 of the
    largest output; two calls bitwise equal."""
    from xhy_flash_attention_tpu_torch.inference import paged
    b, h, hk = 4, 8, 2  # sq * g: 4 and 12 rows decode, 148 and 2048 prefill
    q, cache = _paged_case(cuda, torch.float32, b=b, h=h, hk=hk, d=d, ps=ps,
                           npp=npp, sq=sq,
                           lengths=[npp * ps, 0, npp * ps // 2 + sq, sq])
    q = q.float()
    fn = getattr(paged, f"paged_decode_{entry}")
    before = fn.launches
    out = paged.paged_flash_decode(q, cache, window_size=(window, -1),
                                   softcap=softcap)
    again = paged.paged_flash_decode(q, cache, window_size=(window, -1),
                                     softcap=softcap)
    ref = paged.paged_flash_decode_ref(q, cache, d ** -0.5, (window, -1),
                                       softcap)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again)
    assert not out[1].abs().any()
    assert _err(out, ref) <= 1e-5 * ref.abs().max().item()


def test_fp32_splitkv_matches_plain(cuda):
    """#9 on an fp32 cache: split partials merged, against the plain
    version within 1e-5 of the largest output."""
    from xhy_flash_attention_tpu_torch.inference import combine
    b, h, hk, d, S = 2, 25, 25, 64, 1024
    q = torch.randn(b, 1, h, d, generator=cuda, device="cuda")
    kc, vc = (torch.randn(b, hk, S, d, generator=cuda, device="cuda")
              for _ in range(2))
    lengths = torch.tensor([S, 700], dtype=torch.int32, device="cuda")
    before = combine.flash_decode_splitkv.launches
    out = combine.flash_decode_splitkv(q, kc, vc, lengths, num_splits=3)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5)
    torch.cuda.synchronize()
    assert combine.flash_decode_splitkv.launches == before + 1
    assert out.dtype == torch.float32
    assert _err(out, ref) <= 1e-5 * ref.abs().max().item()


def test_fp32_gpt_config_builds_and_serves_on_the_card(cuda):
    """GPTLMHeadModel(GPTConfig()): the default config (GPT-2 small width,
    fp32) on the card, a forward against the same weights on the CPU
    (plain versions) and a few greedy tokens through decode()."""
    from xhy_flash_attention_tpu_torch import GPTConfig, GPTLMHeadModel, decode
    cfg = GPTConfig()
    assert cfg.dtype == torch.float32
    model = GPTLMHeadModel(cfg)
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=cuda,
                        device="cuda")
    before = fh.fused_heads_fwd.launches
    with torch.inference_mode():
        got, _ = model(ids)
    torch.cuda.synchronize()
    assert fh.fused_heads_fwd.launches == before + cfg.num_hidden_layers
    cpu = GPTLMHeadModel(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want, _ = cpu(ids.cpu())
    assert _err(got.cpu(), want) <= 1e-4 * want.abs().max().item() + 1e-4
    seq, _ = decode(model, ids, 104)
    assert seq.shape == (2, 104) and torch.equal(seq[:, :96], ids)


def test_fp32_refuses_what_its_kernels_lack(cuda):
    """fp16 raises NotImplementedError on the card (its forward and the
    reduced scores), never falling back to a plain version or another
    kernel."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, reduced_scores)
    b, h, s, d = 1, 4, 128, 64
    q = torch.randn(b, h, s, d, generator=cuda, device="cuda")
    before = (fwd.flash_fwd_fp32.launches, fwd.flash_attention_fwd.launches,
              bwd.flash_bwd_dkv_fp32.launches)
    with pytest.raises(NotImplementedError, match="Next slices"):
        fwd.flash_attention_fwd(q.half(), q.half(), q.half(), sm_scale=1.0)
    with pytest.raises(NotImplementedError, match="Next slices"):
        reduced_scores.calc_reduced_attn_scores(
            q.half(), q.half(), torch.zeros(b, h, s, device="cuda"))
    assert (fwd.flash_fwd_fp32.launches, fwd.flash_attention_fwd.launches,
            bwd.flash_bwd_dkv_fp32.launches) == before


# ---- fp32 with an attention bias: the BIAS instantiations of the three
# fp32 kernels (dense and masked) and the fp32 dbias kernel

def _bias_attention64(q, k, v, do, bias, keep):
    """(out, lse, dq, dk, dv, dbias) in float64 with the (bb, bh, sq, sk)
    bias added after softcap-free scores and the keep mask (b|1, h|1, sq,
    sk); dbias in the bias's shape; rows that see no key give 0."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        expand_heads)
    ins = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
    h, g = q.shape[1], q.shape[1] // k.shape[1]
    s = (ins[0] * q.shape[3] ** -0.5) @ ins[1].repeat_interleave(
        g, 1).transpose(-1, -2) + ins[3]
    s = s.masked_fill(~expand_heads(keep, h), float("-inf"))
    out = torch.nan_to_num(torch.softmax(s, -1)) @ ins[2].repeat_interleave(
        g, 1)
    grads = torch.autograd.grad(out, ins, do.double())
    return (out.detach(), torch.logsumexp(s, -1).detach()) + grads


def _fp32_bias_run(cuda, kind, d, hk, sq, sk, causal=True, window=(-1, -1),
                   bias_dtype=torch.float32, **flags):
    """fp32 q/k/v with a bias of ``kind`` through flash_attention_fwd and
    flash_attention_bwd (bias.requires_grad's path): exact launches of the
    fp32 forward, pre-pass, dK/dV, dQ and dbias kernels (no bf16 kernel);
    out, LSE, dq, dk, dv and dbias against float64 within twice the fp32
    plain versions' error plus 1e-4 (_fp32_contract); rows that see no key
    0 with LSE +inf; three backward passes bitwise equal (dQ and dbias
    included)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h = 2, 8
    q, k, v, do = _fp32_case(cuda, b, h, hk, sq, sk, d)
    bias = (2 * torch.randn(_bias_shape(kind, b, h, sq, sk), generator=cuda,
                            device="cuda")).to(bias_dtype)
    eff, masks = fwd.build_masks(b, h, sq, sk, causal, window, **flags)
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    counts = (fwd.flash_fwd_fp32, bwd.flash_bwd_prep, bwd.flash_bwd_dkv_fp32,
              bwd.flash_bwd_dq_fp32, bwd.flash_bwd_dbias_fp32,
              fwd.flash_attention_fwd, bwd.flash_bwd_dkv, bwd.flash_bwd_dq,
              bwd.flash_bwd_dbias)
    before = [c.launches for c in counts]
    out, lse = fwd.flash_attention_fwd(q, k, v, bias, need_lse=True,
                                       masks=masks, **kw)
    runs = [bwd.flash_attention_bwd(q, k, v, out, lse, do, bias, masks=masks,
                                    **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == \
        [1, 3, 3, 3, 3, 0, 0, 0, 0]
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))
    grads = runs[0]
    assert grads[3].shape == bias.shape and grads[3].dtype == bias_dtype
    bias4 = fwd.bias_view(bias, b, h, sq, sk)
    keep = torch.ones(1, 1, sq, sk, dtype=torch.bool, device="cuda")
    if eff:
        keep = keep.tril(sk - sq)
    if masks.keep(h, "cuda") is not None:
        keep = keep & masks.keep(h, "cuda")
    p_out, p_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=keep,
                                         bias=bias4, **dict(kw, causal=False))
    p_grads = bwd.attention_bwd_ref(q, k, v, p_out, p_lse, do, mask=keep,
                                    bias=bias4, **dict(kw, causal=False))
    want = _bias_attention64(q, k, v, do, bias4, keep)
    seen = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(lse), seen)
    assert torch.isinf(lse[~seen]).all() and not out[~seen].any()
    _fp32_contract("out", out, p_out, want[0])
    _fp32_contract("lse", lse[seen], p_lse[seen], want[1][seen])
    for name, g, pg, w in zip(("dq", "dk", "dv", "dbias"), grads, p_grads,
                              want[2:]):
        _fp32_contract(name, g.reshape(w.shape), pg.reshape(w.shape), w)


@pytest.mark.parametrize("hk", [8, 2])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["2d", "3d", "1h", "b1", "bh"])
def test_fp32_bias_kernels_meet_the_contract(cuda, kind, d, hk):
    """Every bias kind through the dense BIAS instantiations, causal, GQA 1
    and 4, sq 257 != sk 333 (odd: the bias copied once into rows of even
    length)."""
    _fp32_bias_run(cuda, kind, d, hk, 257, 333)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("flag", ["softcap", "window", "segments",
                                  "positions", "bf16 bias", "full"])
def test_fp32_bias_with_flags(cuda, flag, d):
    """A bias with softcap (added after it), a window (100, 0), segment ids
    with a padded tail and positions with a window (the masked BIAS
    instantiations), a bf16 bias (widened in the kernels; dbias bf16) and
    no causal mask, GQA 4, odd lengths."""
    if flag == "softcap":
        _fp32_bias_softcap(cuda, d)
        return
    s, kw = 301, {}
    if flag == "window":
        kw = dict(window=(100, -1))
    elif flag in ("segments", "positions"):
        b = 2
        seg = torch.sort(torch.randint(1, 4, (b, s), generator=cuda,
                                       device="cuda"), -1).values.int()
        qseg, kseg = seg.clone(), seg.clone()
        qseg[:, -30:], kseg[:, -17:] = 0, 6
        kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg)
        if flag == "positions":
            pos = (2 * torch.arange(s, device="cuda", dtype=torch.int32))[None]
            kw.update(q_positions=(pos + 40).repeat(b, 1),
                      kv_positions=pos.repeat(b, 1), window=(50, -1))
    elif flag == "bf16 bias":
        kw = dict(bias_dtype=torch.bfloat16)
    elif flag == "full":
        kw = dict(causal=False)
    _fp32_bias_run(cuda, "b1" if d == 64 else "1h", d, 2, s, s, **kw)


def _fp32_bias_softcap(cuda, d):
    """The bias after softcap 20 through the fp32 kernels against the fp32
    plain versions and float64 (its scores softcapped before the bias)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, hk, s = 2, 8, 2, 301
    q, k, v, do = _fp32_case(cuda, b, h, hk, s, s, d)
    bias = 2 * torch.randn(1, h, s, s, generator=cuda, device="cuda")
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=20.0)
    out, lse = fwd.flash_attention_fwd(q, k, v, bias, need_lse=True, **kw)
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, bias, **kw)
    p_out, p_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, bias=bias,
                                         **kw)
    p_grads = bwd.attention_bwd_ref(q, k, v, p_out, p_lse, do, bias=bias,
                                    **kw)
    ins = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
    sc = (ins[0] * d ** -0.5) @ ins[1].repeat_interleave(h // hk, 1).transpose(
        -1, -2)
    sc = torch.tanh(sc / 20.0) * 20.0 + ins[3]
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                   device="cuda").triu(1), float("-inf"))
    o64 = torch.softmax(sc, -1) @ ins[2].repeat_interleave(h // hk, 1)
    want = torch.autograd.grad(o64, ins, do.double())
    _fp32_contract("out", out, p_out, o64.detach())
    _fp32_contract("lse", lse, p_lse, torch.logsumexp(sc, -1).detach())
    for name, g, pg, w in zip(("dq", "dk", "dv", "dbias"), grads, p_grads,
                              want):
        _fp32_contract(name, g, pg.reshape(w.shape), w)


# ---- fp32 under FlashMask, block masks, segment ids and positions (the
# masked instantiations of csrc/flash_fp32.cu) and fp32 #12

def _masked_attention64(q, k, v, do, keep, causal):
    """(out, lse, dq, dk, dv) in float64 under the dense keep mask (b|1,
    hm|1, sq, sk) and the bottom-right causal flag; rows that see no key
    give 0 (lse -inf)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        expand_heads)
    ins = [t.detach().double().requires_grad_() for t in (q, k, v)]
    h, g = q.shape[1], q.shape[1] // k.shape[1]
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = (ins[0] * d ** -0.5) @ ins[1].repeat_interleave(g, 1).transpose(-1, -2)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + sk - sq
        s = s.masked_fill(torch.arange(sk, device=q.device) > rows,
                          float("-inf"))
    s = s.masked_fill(~expand_heads(keep, h), float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = torch.nan_to_num(torch.softmax(s, -1)) @ ins[2].repeat_interleave(
        g, 1)
    grads = torch.autograd.grad(out, ins, do.double())
    return (out.detach(), lse) + grads


def _masked_fp32_flags(kind, b, h, s, gen):
    """(causal, flags, window) of mask ``kind``; causal_2, the block mask,
    the segment ids and the positions leave rows that see no key."""
    from xhy_flash_attention_tpu_torch import causal_document_mask
    if kind.startswith("flashmask"):
        mode = kind.split()[1]
        hm = 2 if mode == "full_4" else 1
        nv = {"causal_1": 1, "causal_2": 2, "full_2": 2, "full_4": 4}[mode]
        if mode == "causal_1":  # a causal document mask
            lens = torch.randint(20, 90, (b, s // 20 + 1), generator=gen,
                                 device="cuda")
            ids = torch.stack([torch.repeat_interleave(
                torch.arange(lens.shape[1], device="cuda"), n)[:s]
                for n in lens])
            return True, dict(flashmask_vecs=causal_document_mask(
                ids).movedim(-1, 2), flashmask_mode=mode), (-1, -1)
        lts = torch.randint(0, s + 1, (b, hm, 1, s), generator=gen,
                            device="cuda")
        if mode == "causal_2":
            vecs = [lts, torch.clamp(lts + torch.randint(
                0, s, lts.shape, generator=gen, device="cuda"), max=s)]
        elif mode == "full_2":
            vecs = [lts, (torch.rand(lts.shape, generator=gen, device="cuda")
                          * (lts + 1)).long()]
        else:
            uts = torch.randint(0, s + 1, lts.shape, generator=gen,
                                device="cuda")
            vecs = [lts, torch.clamp(lts + s // 3, max=s), uts,
                    torch.clamp(uts + s // 3, max=s)]
        vecs = torch.cat(vecs, 2).to(torch.int32)
        first = torch.arange(s, device="cuda") < 9
        vecs[:, :, 0, :] = torch.where(first, 0, vecs[:, :, 0, :])
        if mode == "causal_2":  # rows 0-8 see only the masked columns 0-8
            vecs[:, :, 1, :] = torch.where(first, s, vecs[:, :, 1, :])
        return mode.startswith("causal"), dict(flashmask_vecs=vecs,
                                               flashmask_mode=mode), (-1, -1)
    if kind == "block":  # granularity 64, block row 0 off
        n = -(-s // 64)
        bm = (torch.rand(b, 1, n, n, generator=gen, device="cuda") < 0.6).to(
            torch.int32)
        bm[:, :, 0] = 0
        return False, dict(block_mask=(bm, 64, 64)), (-1, -1)
    seg = torch.sort(torch.randint(1, 5, (b, s), generator=gen,
                                   device="cuda"), -1).values.to(torch.int32)
    qseg, kseg = seg.clone(), seg.clone()
    qseg[:, -30:], kseg[:, -17:] = 0, 6  # padded tails, unequal
    qseg[0, :11] = 9  # an id no key carries: rows that see nothing
    flags = dict(q_segment_ids=qseg, kv_segment_ids=kseg)
    if kind == "positions":
        pos = (2 * torch.arange(s, device="cuda", dtype=torch.int32))[None]
        flags.update(q_positions=(pos + 40).repeat(b, 1),
                     kv_positions=pos.repeat(b, 1))
        return True, flags, (50, -1)
    return kind == "segments causal", flags, (-1, -1)


MASKED_FP32_KINDS = ["flashmask causal_1", "flashmask causal_2",
                     "flashmask full_2", "flashmask full_4", "block",
                     "segments", "segments causal", "positions"]


@pytest.mark.parametrize("hk", [8, 2])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", MASKED_FP32_KINDS)
def test_fp32_masked_kernels_meet_the_contract(cuda, kind, d, hk):
    """The masked fp32 forward, pre-pass, dK/dV and dQ through the public
    wrappers (one launch each, the fp32 kernels only) under each mask:
    out, LSE and every gradient against float64 within twice the fp32
    plain versions' error plus 1e-4; against the plain versions within
    1e-4 of their largest entries; rows that see no key give 0 and LSE
    +inf; a second backward bitwise equal; the tiles the kernels visit
    equal to the fp32 mirrors of fwd.py and bwd.py."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, s = 2, 8, 300
    causal, flags, window = _masked_fp32_flags(kind, b, h, s, cuda)
    q, k, v, do = _fp32_case(cuda, b, h, hk, s, s, d)
    eff, masks = fwd.build_masks(b, h, s, s, causal, window, **flags)
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    counts = (fwd.flash_fwd_fp32, bwd.flash_bwd_prep, bwd.flash_bwd_dkv_fp32,
              bwd.flash_bwd_dq_fp32, fwd.flash_attention_fwd,
              bwd.flash_bwd_dkv, bwd.flash_bwd_dq)
    before = [c.launches for c in counts]
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, masks=masks,
                                       **kw)
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, masks=masks, **kw)
    again = bwd.flash_attention_bwd(q, k, v, out, lse, do, masks=masks, **kw)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == \
        [1, 2, 2, 2, 0, 0, 0]
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    keep = masks.keep(h, "cuda")
    p_out, p_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=keep,
                                         **kw)
    p_grads = bwd.attention_bwd_ref(q, k, v, p_out, p_lse, do, mask=keep,
                                    **kw)
    want = _masked_attention64(q, k, v, do, keep, eff)
    seen = torch.isfinite(want[1])
    if kind not in ("flashmask causal_1", "flashmask full_2",
                    "flashmask full_4"):
        assert (~seen).any()
    assert torch.isinf(lse[~seen]).all() and not out[~seen].any()
    assert torch.equal(torch.isfinite(lse), seen)
    _fp32_contract("out", out, p_out, want[0])
    _fp32_contract("lse", lse[seen], p_lse[seen], want[1][seen])
    for name, g, pg, w in zip(("dq", "dk", "dv"), grads, p_grads, want[2:]):
        _fp32_contract(name, g, pg, w)
        assert _err(g, pg) <= 1e-4 * pg.abs().max().item() + 1e-6, name
    assert _err(out, p_out) <= 1e-4 * p_out.abs().max().item() + 1e-6
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    counted = []
    cnt = torch.zeros(3, dtype=torch.int32, device="cuda")
    fwd.launch_flash_fwd(q, k, v, torch.empty_like(out), None, masks=masks,
                         tile_counts=cnt, **kw)
    counted.append(cnt[1:].tolist())
    for which in ("dkv", "dq"):
        cnt = torch.zeros(3, dtype=torch.int32, device="cuda")
        bwd.launch_flash_bwd(which, qs, k, v, do, lse, delta,
                             *(torch.empty_like(g) for g in grads),
                             masks=masks, tile_counts=cnt, **kw)
        counted.append(cnt[1:].tolist())
    mirror = []
    for plan in (fwd.fwd_masked_tile_plan(masks, b, h, s, s, eff, d, True),
                 bwd.bwd_masked_dkv_tile_plan(masks, b, h, hk, s, s, eff, d,
                                              True),
                 bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, s, s, eff, d,
                                             True)):
        tiles = [t for ts in plan.values() for t in ts]
        mirror.append([len(tiles), sum(1 for t in tiles if t[-2])])
    assert counted == mirror


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_varlen_matches_plain(cuda, d):
    """flash_attn_varlen_func and flash_attn_varlen_kvpacked_func in fp32
    (the masked fp32 kernels on segment ids and positions), causal, GQA,
    cu_seqlens_q != cu_seqlens_k: out and gradients against float64 under
    the contract, one masked fp32 launch of each kernel per call."""
    from xhy_flash_attention_tpu_torch import (
        flash_attn_varlen_func, flash_attn_varlen_kvpacked_func)
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    h, hk = 8, 2
    cu_q = torch.tensor([0, 100, 130, 400, 410], dtype=torch.int32,
                        device="cuda")
    cu_k = torch.tensor([0, 60, 250, 500, 530], dtype=torch.int32,
                        device="cuda")
    tq, tk = 410, 530
    q = torch.randn(tq, h, d, generator=cuda, device="cuda")
    k, v = (torch.randn(tk, hk, d, generator=cuda, device="cuda")
            for _ in range(2))
    do = torch.randn(tq, h, d, generator=cuda, device="cuda")
    before = [c.launches for c in (fwd.flash_fwd_fp32, bwd.flash_bwd_dkv_fp32,
                                   bwd.flash_bwd_dq_fp32)]
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attn_varlen_func(*ins, cu_q, cu_k, 300, 300, causal=True)
    grads = torch.autograd.grad(out, ins, do)
    kv = torch.stack([k, v], 1).requires_grad_()
    qp = q.clone().requires_grad_()
    out2 = flash_attn_varlen_kvpacked_func(qp, kv, cu_q, cu_k, 300, 300,
                                           causal=True)
    g2 = torch.autograd.grad(out2, (qp, kv), do)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(
        (fwd.flash_fwd_fp32, bwd.flash_bwd_dkv_fp32, bwd.flash_bwd_dq_fp32),
        before)] == [2, 2, 2]
    assert torch.equal(out, out2) and torch.equal(grads[0], g2[0])
    assert torch.equal(grads[1], g2[1][:, 0]) and torch.equal(grads[2],
                                                              g2[1][:, 1])
    cpu = [t.cpu() for t in (q, k, v, do)]
    p_ins = [t.clone().requires_grad_() for t in cpu[:3]]
    p_out = flash_attn_varlen_func(*p_ins, cu_q.cpu(), cu_k.cpu(), 300, 300,
                                   causal=True)
    p_grads = torch.autograd.grad(p_out, p_ins, cpu[3])
    for i, (lo_q, hi_q, lo_k, hi_k) in enumerate(zip(
            cu_q[:-1].tolist(), cu_q[1:].tolist(), cu_k[:-1].tolist(),
            cu_k[1:].tolist())):
        sq, sk = hi_q - lo_q, hi_k - lo_k
        if sq == 0:
            continue
        seg = [t[None].transpose(1, 2) for t in (
            cpu[0][lo_q:hi_q], cpu[1][lo_k:hi_k], cpu[2][lo_k:hi_k],
            cpu[3][lo_q:hi_q])]
        want = _masked_attention64(*seg, torch.ones(1, 1, sq, sk,
                                                    dtype=torch.bool), True)
        back = lambda t, lo, hi: t[lo:hi][None].transpose(1, 2)  # noqa: E731
        _fp32_contract(f"out {i}", back(out.detach().cpu(), lo_q, hi_q),
                       back(p_out.detach(), lo_q, hi_q), want[0])
        for name, g, pg, w, lo, hi in (
                ("dq", grads[0], p_grads[0], want[2], lo_q, hi_q),
                ("dk", grads[1], p_grads[1], want[3], lo_k, hi_k),
                ("dv", grads[2], p_grads[2], want[4], lo_k, hi_k)):
            _fp32_contract(f"{name} {i}", back(g.cpu(), lo, hi),
                           back(pg, lo, hi), w)


@pytest.mark.parametrize("sq,sk,hk,causal", [(700, 700, 2, True),
                                             (300, 900, 8, False),
                                             (1000, 200, 4, True)])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_reduced_scores_match_plain(cuda, d, sq, sk, hk, causal):
    """#12 in fp32 (reduced_scores_fp32_kernel): on a masked fp32 forward's
    LSE with rows +inf, against float64 within twice the fp32 plain
    version's error + 1e-4 of the largest score, within 1e-4 of it against
    the plain version; one launch a call, two calls bitwise equal."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        reduced_scores as rs)
    b, h = 2, 8
    q = torch.randn(b, h, sq, d, generator=cuda, device="cuda")
    k = torch.randn(b, hk, sk, d, generator=cuda, device="cuda")
    _, lse = fwd.flash_attention_fwd(q, k, k, sm_scale=d ** -0.5,
                                     causal=True)
    lse[0, 1, :5] = float("inf")
    before = rs.calc_reduced_attn_scores.launches
    got = rs.calc_reduced_attn_scores(q, k, lse, causal=causal)
    again = rs.calc_reduced_attn_scores(q, k, lse, causal=causal)
    torch.cuda.synchronize()
    assert rs.calc_reduced_attn_scores.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    plain = rs.reduced_scores_ref(q, k, lse, sm_scale=d ** -0.5,
                                  causal=causal)
    kr = k.double().repeat_interleave(h // hk, 1)
    p = torch.exp((q.double() @ kr.transpose(-1, -2)) * d ** -0.5
                  - lse.double()[..., None])
    if causal:
        hidden = torch.arange(sk, device="cuda")[None] > (
            torch.arange(sq, device="cuda")[:, None] + sk - sq)
        p = p.masked_fill(hidden, 0.0)
    want = p.sum(-2)
    top = want.abs().max().item()
    assert _err(got, want) <= 2 * _err(plain, want) + 1e-4 * top
    assert _err(got, plain) <= 1e-4 * plain.abs().max().item()


# ------------------------------------------------------- attention dropout

def _dropout_counts():
    """Copies of the dropout instantiations' launch counts: the forward's
    and the backward's (fwd.dropout_instance's names)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    return (collections.Counter(fwd.launch_flash_fwd.dropout_launches),
            collections.Counter(bwd.launch_flash_bwd.dropout_launches))


def _dropout_kernels_vs_plain(cuda, b, h, hk, sq, sk, d, causal, softcap=0.0,
                              seed=5, **flags):
    """#1, #2 and #3 with dropout (p 0.1) through flash_attention_fwd /
    flash_attention_bwd, one launch of each dropout instantiation, against
    the plain versions under the same keep mask: out to one bf16 unit of
    its largest entry + 1e-3, the LSE to 1e-3, each gradient to four bf16
    units (P, dS rounded in sums of another order); a second backward
    bitwise equal."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        Dropout)
    (_, _, _, _), (q, k, v, _, _, do), kw = _bwd_case(
        cuda, b, h, hk, sq, sk, d, causal, softcap)
    drop = Dropout.make(0.1, seed)
    causal_eff, kmasks = fwd.build_masks(b, h, sq, sk, causal,
                                         flags.pop("window", (-1, -1)),
                                         **flags)
    kw = dict(kw, causal=causal_eff)
    inst = fwd.dropout_instance(d, kmasks is not None and kmasks.active)
    entry = dict(kw, masks=kmasks, dropout_p=0.1, dropout_seed=seed)
    f0, b0 = _dropout_counts()
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **entry)
    got = bwd.flash_attention_bwd(q, k, v, out, lse, do, **entry)
    torch.cuda.synchronize()
    f1, b1 = _dropout_counts()
    assert f1 - f0 == {inst: 1}
    assert b1 - b0 == {f"dkv {inst}": 1, f"dq {inst}": 1}
    mask = kmasks.keep(h, q.device)
    ref, ref_lse = fwd.attention_fwd_ref(q, k, v, need_lse=True, mask=mask,
                                         dropout=drop, **kw)
    want = bwd.attention_bwd_ref(q, k, v, out, lse, do, mask=mask,
                                 dropout=drop, **kw)
    assert _err(out, ref) <= BF16_ULP * ref.float().abs().max().item() + 1e-3
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert _err(lse[finite], ref_lse[finite]) <= 1e-3
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _err(g, w) <= 4 * BF16_ULP * w.float().abs().max().item() + 1e-4
    again = bwd.flash_attention_bwd(q, k, v, out, lse, do, **entry)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 0.0),
                                            (True, 20.0)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333), (1000, 100)])
def test_dropout_kernels_match_plain(cuda, sq, sk, g, causal, softcap, d):
    """The dense dropout instantiations: GQA groups 1 and 4 (every head its
    own mask), sq != sk (the bottom-right diagonal), ragged tiles,
    softcap."""
    _dropout_kernels_vs_plain(cuda, 2, 2 * g, 2, sq, sk, d, causal, softcap)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("flag", ["window", "segments", "positions",
                                  "block_mask", "flashmask"])
def test_dropout_masked_kernels_match_plain(cuda, flag, d):
    """The masked dropout instantiations under each flag (s 333, GQA 2)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        fm_mode_for)
    b, h, hk, s = 2, 4, 2, 333
    flags = {}
    if flag == "window":
        flags = dict(window=(100, -1))
    elif flag == "segments":
        flags = dict(q_segment_ids=_ids(cuda, b, s, 4, True, pad=30),
                     kv_segment_ids=_ids(cuda, b, s, 4, True, pad=11))
    elif flag == "positions":
        pos = torch.arange(s, device="cuda", dtype=torch.int32)
        flags = dict(q_positions=(pos // 2)[None].repeat(b, 1),
                     kv_positions=pos[None].repeat(b, 1))
    elif flag == "block_mask":
        bm = torch.randint(0, 2, (b, 1, 3, 3), generator=cuda,
                           device="cuda").to(torch.int32)
        bm[:, :, :, 0] = 1
        flags = dict(block_mask=(bm, 128, 128))
    else:
        ends = torch.randint(s // 2, s + 1, (b, 1, 1, s), generator=cuda,
                             device="cuda").to(torch.int32)
        flags = dict(flashmask_vecs=ends.sort(-1).values,
                     flashmask_mode=fm_mode_for(True, 1))
    _dropout_kernels_vs_plain(cuda, b, h, hk, s, s, d, True, **flags)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_dropout_keep_mask_bitwise(cuda, masked, d):
    """The keep mask the forward applies, read back bit for bit: q = 0
    makes P uniform over a row's visible keys, and V one-hot on a window of
    d keys puts key w0 + j's kept bit in column j of the output (every
    window, so every key of the call; sq 320, sk 512, causal under a block
    mask of ones for the masked instantiation)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        Dropout)
    b, h, hk, sq, sk = 2, 4, 2, 320, 512
    z = dict(dtype=torch.bfloat16, device="cuda")
    flags = dict(block_mask=(torch.ones(1, 1, 3, 4, dtype=torch.int32,
                                        device="cuda"), 128, 128)) \
        if masked else {}
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    vis = cols <= rows + (sk - sq) if masked else torch.ones_like(rows == cols)
    q, kz = torch.zeros(b, h, sq, d, **z), torch.zeros(b, hk, sk, d, **z)
    for seed, p in ((0, 0.1), (-3, 0.5), (77, 0.9)):
        drop = Dropout.make(p, seed)
        keep = drop.keep(b, h, sq, sk, "cuda") & vis
        for w0 in range(0, sk, d):
            v = torch.zeros(b, hk, sk, d, **z)
            v[:, :, w0:w0 + d] = torch.eye(d, **z)
            out, _ = fwd.flash_attention_fwd(q, kz, v, sm_scale=d ** -0.5,
                                             causal=masked, need_lse=False,
                                             dropout_p=p, dropout_seed=seed,
                                             **flags)
            assert torch.equal(out != 0, keep[..., w0:w0 + d])


def test_dropout_packed_matches_plain(cuda):
    """#5 / #6 with dropout through the packed qkv entry's autograd: out and
    the packed dqkv against the plain versions, the dropout instantiations
    launched once each."""
    b, s, h, d = 2, 300, 4, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=cuda,
                      device="cuda").bfloat16().requires_grad_()
    do = torch.randn(b, s, h * d, generator=cuda, device="cuda").bfloat16()
    kw = dict(num_heads=h, num_heads_kv=h, head_dim=d, causal=True,
              dropout_p=0.1, dropout_seed=9)
    f0, b0 = _dropout_counts()
    out = fh.packed_qkv_attention(qkv, **kw)
    (g,) = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    f1, b1 = _dropout_counts()
    assert f1 - f0 == {"d64": 1} and b1 - b0 == {"dkv d64": 1, "dq d64": 1}
    cpu = qkv.detach().cpu().requires_grad_()
    want = fh.packed_qkv_attention(cpu, **kw)
    (want_g,) = torch.autograd.grad(want, cpu, do.cpu())
    out, g = out.cpu(), g.cpu()
    assert _err(out, want) <= BF16_ULP * want.float().abs().max().item() + 1e-3
    assert _err(g, want_g) <= 4 * BF16_ULP * want_g.float().abs().max().item() \
        + 1e-4


def test_dropout_refusals_launch_nothing(cuda):
    """On the card: dropout with float32 q/k/v or beside an attention bias
    raises NotImplementedError, with e4m3 ValueError, each before any
    launch."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, flash_attention)
    q = torch.randn(1, 2, 128, 64, generator=cuda, device="cuda")
    drop = dict(dropout_p=0.1, dropout_seed=1)
    count = lambda: (fwd.flash_attention_fwd.launches,  # noqa: E731
                     fwd.flash_fwd_fp32.launches, fwd.flash_fwd_fp8.launches,
                     bwd.flash_bwd_prep.launches)
    before = count()
    with pytest.raises(NotImplementedError, match="float32"):
        flash_attention(q, q, q, **drop)
    with pytest.raises(NotImplementedError, match="bias"):
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                        torch.zeros(128, 128, device="cuda"), **drop)
    with pytest.raises(ValueError):
        e4 = q.to(torch.float8_e4m3fn)
        flash_attention(e4, e4, e4, **drop)
    torch.cuda.synchronize()
    assert count() == before
