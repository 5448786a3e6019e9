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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1100, 1100), (77, 300), (300, 77)])
def test_flash_fwd_matches_plain(cuda, sq, sk, causal, softcap, d):
    b, h, hk = 2, 8, 2
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
    _contract(out.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
              v.transpose(1, 2), causal, softcap)


@pytest.mark.parametrize("h,hk", [(32, 8), (8, 8)])
def test_fused_heads_matches_plain(cuda, h, hk):
    b, s, d = 2, 960, 128
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
