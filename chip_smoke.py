#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py    # Llama-3-8B width, all 32 layers, one card

Phases (any failure raises and exits non-zero, with no "ok" line):
  1. the card: name and power limit (nvidia-smi), capability (9, 0);
  2. build: every CUDA kernel of xhy_flash_attention_tpu_torch/csrc is
     compiled from source (ptxas report printed);
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the serving path gives it, with max error, tolerance and times
     (kernel, plain version, one PyTorch library call, roofline bound);
  4. the slice: random bf16 weights at Llama-3-8B width serve request A
     (batch 2, prompt 2048, max_length 2080) and request B (batch 2,
     prompt 960, max_length 1024) through `decode`; launch counts of every
     kernel are checked exactly, and a second prefill over prompt +
     generated tokens is checked against the decode-step logits;
  5. the kernel path against the plain path at full width and depth: the
     prefill and one decode step of each request, once through the
     kernels and once through their plain versions on the same tensors
     and caches;
  6. where the time goes: a few decode steps of each request under
     torch.profiler, device time by kernel group and the idle share;
  7. a tiny model on the card against the fp32 plain path on the CPU.
The last lines: the card, one JSON object with a row per kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import subprocess
import sys
import time
import types

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
BF16_ULP = 2.0 ** -7       # one bf16 unit in the last place, relative

LLAMA3_8B = dict(  # meta-llama/Meta-Llama-3-8B config.json
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
LAYERS = LLAMA3_8B["num_hidden_layers"]
REQUESTS = {"A": (2, 2048, 2080), "B": (2, 960, 1024)}  # batch, prompt, max_length


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fns, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, cycling over ``fns`` (distinct input
    sets, so that inputs bigger together than L2 arrive cold)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, flop_rate: float, nbytes: float):
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def report(row: dict, extra: str) -> None:
    print(f"  {row['name']}: max_abs_err {row['max_abs_err']:.3g} "
          f"({extra}); ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
          f"library_ms {row['library_ms']:.4f}, bound_ms "
          f"{row['bound_ms']:.4f} by {row['bound_by']} "
          f"(roofline share {row['bound_ms'] / row['ms']:.3f})", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 3

def check_norm(gen):
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    b, s, _ = REQUESTS["A"]
    rows, hid = b * s, LLAMA3_8B["hidden_size"]
    eps = LLAMA3_8B["rms_norm_eps"]
    x0 = torch.randn(rows, hid, generator=gen, device="cuda").bfloat16()
    res = torch.randn(rows, hid, generator=gen, device="cuda") * 4
    gamma = 1 + 0.1 * torch.randn(hid, generator=gen, device="cuda")
    args = (x0, res, gamma, None, eps, True, torch.float32, True)
    out, resout = ln.ln_fwd(*args)
    ref, ref_res = ln.ln_fwd_ref(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    err_res = max_err(resout, ref_res)
    tol = BF16_ULP * ref.float().abs().max().item()
    check(err <= tol, f"rms_norm_add out err {err} > {tol}")
    check(err_res <= 1e-6 * ref_res.abs().max().item(),
          f"rms_norm_add residual err {err_res}")
    # x0 bf16 and residual fp32 in, out bf16 and residual fp32 out, gamma
    nbytes = rows * hid * (2 + 4 + 2 + 4) + hid * 4
    flops = 6.0 * rows * hid  # add, square, sum, scale twice, gamma
    bms, by = bound(flops, PEAK_FP32_FLOPS, nbytes)
    row = dict(
        name="rms_norm_add", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/rms_norm_add.cu",
        replaces="xhy_flash_attention_tpu/ops/layer_norm.py:48",
        max_abs_err=err,
        ms=time_ms([lambda: ln.ln_fwd(*args)]),
        plain_ms=time_ms([lambda: ln.ln_fwd_ref(*args)]),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms([lambda: F.rms_norm(
            x0.float() + res, (hid,), gamma, eps)]))
    report(row, f"tol {tol:.3g} = 1 bf16 ulp of max|out|; residual err "
                f"{err_res:.3g}; rows {rows} hidden {hid}, flops {flops:.4g}, "
                f"bytes {nbytes}")
    return row


def _attn_contract(out_bshd, q, k, v, causal):
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_ref
    ref, _ = attention_ref(q, k, v, causal=causal, upcast=True)
    lp, _ = attention_ref(q, k, v, causal=causal, upcast=False,
                          reorder_ops=True)
    e, e_lp = max_err(out_bshd, ref), max_err(lp, ref)
    del ref, lp
    check(e <= 2 * e_lp + 1e-4,
          f"attention err vs fp32 ref {e} > 2 x bf16 baseline {e_lp}")
    return e, e_lp


def _qkv(gen, b, s):
    c = LLAMA3_8B
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    # the projection layout of the serving path: one packed Wqkv output
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                      device="cuda").bfloat16()
    q = qkv[..., : h * d].view(b, s, h, d)
    k = qkv[..., h * d: (h + hk) * d].view(b, s, hk, d)
    v = qkv[..., (h + hk) * d:].view(b, s, hk, d)
    return q, k, v, (b, h, hk, s, d)


def _attn_flops_bytes(b, h, hk, s, d):
    flops = 4.0 * b * h * s * s * d / 2  # causal, as bench.py:92 counts
    nbytes = 2.0 * b * s * d * (2 * h + 2 * hk)  # q, k, v in; o out
    return flops, nbytes


def check_flash_fwd(gen):
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    b, s, _ = REQUESTS["A"]
    q, k, v, (b, h, hk, s, d) = _qkv(gen, b, s)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    ref, ref_lse = fwd.attention_fwd_ref(qt, kt, vt, need_lse=True, **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    err_lse = max_err(lse, ref_lse)
    check(err_lse <= 1e-3, f"flash_fwd lse err {err_lse}")
    e, e_lp = _attn_contract(out.transpose(1, 2), q, k, v, True)
    flops, nbytes = _attn_flops_bytes(b, h, hk, s, d)
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    row = dict(
        name="flash_fwd (flash_attention_fwd)", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78",
        max_abs_err=err,
        ms=time_ms([lambda: fwd.flash_attention_fwd(
            qt, kt, vt, need_lse=False, **kw)]),
        plain_ms=time_ms([lambda: fwd.attention_fwd_ref(
            qt, kt, vt, need_lse=False, **kw)], iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)]))
    report(row, f"vs fp32 attention_ref {e:.3g} <= 2 x bf16 baseline "
                f"{e_lp:.3g}; lse err {err_lse:.3g}; b{b} h{h} hk{hk} s{s} "
                f"d{d} causal, flops {flops:.4g}, bytes {nbytes:.4g}")
    return row


def check_fused_heads(gen):
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads
    b, s, _ = REQUESTS["B"]
    q, k, v, (b, h, hk, s, d) = _qkv(gen, b, s)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out = fused_heads.fused_heads_fwd(q, k, v, **kw)
    ref = fused_heads.fused_heads_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    e, e_lp = _attn_contract(out, q, k, v, True)
    flops, nbytes = _attn_flops_bytes(b, h, hk, s, d)
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = dict(
        name="flash_fwd (fused_heads)", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:59",
        max_abs_err=err,
        ms=time_ms([lambda: fused_heads.fused_heads_fwd(q, k, v, **kw)]),
        plain_ms=time_ms([lambda: fused_heads.fused_heads_fwd_ref(
            q, k, v, **kw)], iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)]))
    report(row, f"vs fp32 attention_ref {e:.3g} <= 2 x bf16 baseline "
                f"{e_lp:.3g}; packed layout b{b} s{s} h{h} hk{hk} d{d} "
                f"causal, flops {flops:.4g}, bytes {nbytes:.4g}")
    return row


def check_decode(gen, request: str):
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    c = LLAMA3_8B
    b, _, S = REQUESTS[request]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    # enough cache copies that they exceed the 50 MB L2 together: every
    # layer of a decode step finds its cache cold
    per_set = 2 * b * hk * S * d * 2
    n_sets = max(1, math.ceil(128e6 / per_set))
    sets = []
    for _ in range(n_sets):
        kc = torch.randn(b, hk, S, d, generator=gen, device="cuda").bfloat16()
        vc = torch.randn(b, hk, S, d, generator=gen, device="cuda").bfloat16()
        sets.append((kc, vc))
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    kc, vc = sets[0]
    # ragged lengths first (length handling), then the last step's lengths
    ragged = torch.tensor([S, S - 29], dtype=torch.int32, device="cuda")
    err_ragged = max_err(dk.flash_decode(q, kc, vc, ragged, softmax_scale=scale),
                         dk.flash_decode_ref(q, kc, vc, ragged, scale))
    lengths = torch.full((b,), S, dtype=torch.int32, device="cuda")
    out = dk.flash_decode(q, kc, vc, lengths, softmax_scale=scale)
    ref = dk.flash_decode_ref(q, kc, vc, lengths, scale)
    torch.cuda.synchronize()
    err = max(max_err(out, ref), err_ragged)
    tol = BF16_ULP * ref.float().abs().max().item() + 1e-6
    check(err <= tol, f"flash_decode err {err} > {tol}")
    n_tok = int(lengths.sum().item())
    # the cache positions read (k and v, bf16), q in and out
    nbytes = 2.0 * hk * n_tok * d * 2 + 2 * 2.0 * b * h * d
    flops = 4.0 * h * n_tok * d  # q.k and p.v for every head
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    row = dict(
        name="flash_decode", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_decode.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/decode_kernel.py:47",
        max_abs_err=err,
        ms=time_ms([lambda kc=kc, vc=vc: dk.flash_decode(
            q, kc, vc, lengths, softmax_scale=scale) for kc, vc in sets],
            iters=10 * n_sets),
        plain_ms=time_ms([lambda: dk.flash_decode_ref(
            q, kc, vc, lengths, scale)]),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms([lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, enable_gqa=True) for kc, vc in sets],
            iters=10 * n_sets))
    report(row, f"request {request} last step: tol {tol:.3g} = 1 bf16 ulp "
                f"of max|out|; b{b} h{h} hk{hk} len {S} d{d}, flops {flops:.4g}, bytes "
                f"{nbytes:.4g}, {n_sets} cache copies rotated")
    del sets
    return row


# ---------------------------------------------------------------- phase 4

def counters():
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        decode_kernel, fused_heads, fwd)
    from xhy_flash_attention_tpu_torch.ops import layer_norm
    return {"rms_norm_add": layer_norm.ln_fwd,
            "flash_fwd (flash_attention_fwd)": fwd.flash_attention_fwd,
            "flash_fwd (fused_heads)": fused_heads.fused_heads_fwd,
            "flash_decode": decode_kernel.flash_decode}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expected_counts(prompt: int, max_length: int):
    steps = max_length - prompt
    return {"rms_norm_add": (2 * LAYERS + 1) * (1 + steps),
            "flash_fwd (flash_attention_fwd)": LAYERS if prompt > 1024 else 0,
            "flash_fwd (fused_heads)": LAYERS if prompt <= 1024 else 0,
            "flash_decode": LAYERS * steps}


# Two paths that round differently in bf16 give logits that differ by
# rounding noise, which the 32 random-weight layers carry to the logits.
# Readings on an H100 (seed 0, all 32 layers; they repeat run to run):
# decode against a second prefill, largest difference 0.3213 logit, rms
# 0.0555; kernel path against plain path, prefill 0.3145 (rms 0.0487),
# one decode step 0.1562 (rms 0.0319).
NOISE_RMS = 0.056       # logits; the largest per-logit rms of the readings
LOGIT_TOL = 0.45        # logits; largest |difference| allowed, 1.4x reading
RMS_TOL = 1.5 * NOISE_RMS
# A greedy token may differ only where the other path's logits put it
# within NEAR_TIE of their maximum: four standard deviations of the
# difference of two noisy logits (over thousands of positions a
# three-deviation bound is crossed by chance).
NEAR_TIE = 4 * math.sqrt(2) * NOISE_RMS


def compare_logits(what, got, want, tokens=None):
    """Hold bf16 logits ``got`` (b, n, vocab) against ``want`` of another
    path. ``tokens`` (b, n) are the greedy tokens taken from ``got`` (its
    argmax when None). Prints and checks the largest difference, the
    per-logit noise and the tokens that differ."""
    got, want = got.float(), want.float()
    diff = got - want
    dmax = diff.abs().max().item()
    rms = diff.square().mean().sqrt().item()
    if tokens is None:
        tokens = got.argmax(-1)
    # how far below ``want``'s own maximum the taken token lies
    gap = want.max(-1).values - want.gather(-1, tokens[..., None])[..., 0]
    differ = gap > 0
    n_differ = int(differ.sum().item())
    worst = gap.max().item()
    print(f"  {what}: max |difference| {dmax:.4g} logit (tol {LOGIT_TOL}), "
          f"rms {rms:.4g} (tol {RMS_TOL:.4g}), max|logit| "
          f"{want.abs().max().item():.4g}; greedy tokens differ "
          f"{n_differ}/{tokens.numel()}, largest gap {worst:.4g} (near-tie "
          f"bound {NEAR_TIE:.4g})", flush=True)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    check(dmax <= LOGIT_TOL, f"{what}: logits differ by {dmax} > {LOGIT_TOL}")
    check(rms <= RMS_TOL, f"{what}: rms difference {rms} > {RMS_TOL}")
    check(worst <= NEAR_TIE,
          f"{what}: a greedy token differs by {worst} > {NEAR_TIE}")
    return dict(max_diff=dmax, rms=rms, tokens_differ=n_differ,
                tokens=tokens.numel(), largest_gap=worst)


def serve(model, gen, name):
    from xhy_flash_attention_tpu_torch import decode
    b, prompt, max_length = REQUESTS[name]
    vocab = model.config.vocab_size
    ids = torch.randint(0, vocab, (b, prompt), generator=gen, device="cuda")
    decode(model, ids, prompt + 2)  # warm-up: library handles and plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    seq, scores = decode(model, ids, max_length, return_scores=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_counts(prompt, max_length)
    check(counts == want, f"request {name}: launches {counts} != {want}")
    steps = max_length - prompt
    check(seq.shape == (b, max_length) and scores.shape == (b, steps, model.config.padded_vocab_size),
          f"request {name}: shapes {tuple(seq.shape)} {tuple(scores.shape)}")
    check(bool(torch.equal(seq[:, :prompt], ids)), "prompt not kept")

    with torch.inference_mode():
        prefill_times = []
        for _ in range(3):
            caches = model.allocate_kv_caches(b, max_length)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(ids, kv_caches=caches, seqlen_offset=0)
            torch.cuda.synchronize()
            prefill_times.append(time.perf_counter() - t0)
            del caches
        prefill_s = sorted(prefill_times)[1]
        # consistency: one prefill over prompt + generated tokens
        logits, _ = model(seq)
    decode_s = total_s - prefill_s
    print(f"  request {name}: b{b} prompt {prompt} max_length {max_length}: "
          f"total {total_s:.4f} s, prefill {prefill_s:.4f} s "
          f"({b * prompt / prefill_s:.1f} tok/s), decode {decode_s:.4f} s "
          f"({b * steps / decode_s:.1f} tok/s, {decode_s / steps * 1e3:.3f} "
          f"ms/step), max_memory_allocated {peak / 2**30:.3f} GiB", flush=True)
    compare_logits(f"request {name} decode logits vs a second prefill",
                   scores, logits[:, prompt - 1: max_length - 1],
                   seq[:, prompt:])
    print(f"  request {name} kernels: " + json.dumps(
        [{"tpu_kernel": TPU_OF[k], "cuda": k, "launches": v}
         for k, v in counts.items()]), flush=True)
    return counts, dict(prefill_s=prefill_s, decode_s=decode_s,
                        total_s=total_s, peak=peak)


# ---------------------------------------------------------------- phase 5

_PKG = "xhy_flash_attention_tpu_torch.ops."


@contextlib.contextmanager
def plain_versions():
    """Route the model's four kernel calls to their plain PyTorch versions,
    which run on the card's tensors as they are; restored on exit."""
    ln = importlib.import_module(_PKG + "layer_norm")
    fwd = importlib.import_module(_PKG + "flash_attention.fwd")
    fh = importlib.import_module(_PKG + "flash_attention.fused_heads")
    iface = importlib.import_module(_PKG + "flash_attention.interface")
    dk = importlib.import_module(_PKG + "flash_attention.decode_kernel")
    dec = importlib.import_module(_PKG + "decode")

    def attention(q, k, v, *unused, sm_scale, causal, softcap, need_lse,
                  **flags):
        return fwd.attention_fwd_ref(q, k, v, sm_scale=sm_scale,
                                     causal=causal, softcap=softcap,
                                     need_lse=need_lse)

    def decode(q, k_cache, v_cache, lengths, *, softmax_scale, window_size,
               softcap, **unused):
        return dk.flash_decode_ref(q, k_cache, v_cache, lengths,
                                   softmax_scale, window_size, softcap)

    patches = [(ln, "ln_fwd", ln.ln_fwd_ref),
               (iface, "flash_attention_fwd", attention),
               (fh, "fused_heads_fwd", fh.fused_heads_fwd_ref),
               (dec, "flash_decode", decode)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kernel_vs_plain(model, gen, name):
    """Request ``name``'s prefill and one decode step at full width and
    depth, through the kernels and through their plain versions: the
    prefill on the same prompt, the decode step on copies of the same
    caches (filled by the kernels' prefill) with the same token."""
    b, prompt, max_length = REQUESTS[name]
    ids = torch.randint(0, model.config.vocab_size, (b, prompt),
                        generator=gen, device="cuda")
    with torch.inference_mode():
        caches = model.allocate_kv_caches(b, max_length)
        kern, _ = model(ids, kv_caches=caches)
        plain_caches = [(k.clone(), v.clone()) for k, v in caches]
        reset_counts()
        with plain_versions():
            plain, _ = model(ids)
        check(all(v == 0 for v in read_counts().values()),
              f"the plain prefill launched a kernel: {read_counts()}")
        compare_logits(f"request {name} prefill, kernels vs plain", kern,
                       plain)
        tok = kern[:, -1:].argmax(-1)
        del kern, plain
        kern, _ = model(tok, kv_caches=caches, seqlen_offset=prompt)
        with plain_versions():
            plain, _ = model(tok, kv_caches=plain_caches,
                             seqlen_offset=prompt)
        want = {**{k: 0 for k in counters()}, "flash_decode": LAYERS,
                "rms_norm_add": 2 * LAYERS + 1}
        check(read_counts() == want,
              f"decode steps launched {read_counts()}, not {want}")
        compare_logits(f"request {name} decode step, kernels vs plain", kern,
                       plain)
        k_err = max(max_err(a[0], c[0]) for a, c in zip(caches, plain_caches))
        print(f"  request {name}: caches after the step, max |kernel - "
              f"plain| {k_err:.4g}", flush=True)


TPU_OF = {
    "rms_norm_add": "ops/layer_norm.py:48 _ln_fwd_kernel",
    "flash_fwd (flash_attention_fwd)": "ops/flash_attention/fwd.py:78 _fwd_kernel",
    "flash_fwd (fused_heads)": "ops/flash_attention/fused_heads.py:59 _fwd_kernel",
    "flash_decode": "ops/flash_attention/decode_kernel.py:47 _decode_kernel",
}


# ---------------------------------------------------------------- phase 6

KERNEL_GROUPS = (  # device kernel name fragment -> group
    ("flash_decode_kernel", "flash_decode"),
    ("flash_fwd_kernel", "flash_fwd"),
    ("ln_fwd_kernel", "rms_norm_add"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("nvjet", "matmul"), ("splitk", "matmul"),
)


def _group(kernel: str) -> str:
    low = kernel.lower()
    return next((g for frag, g in KERNEL_GROUPS if frag.lower() in low),
                "other")


def decode_breakdown(model, gen, name, steps: int = 8):
    """Where a decode step's time goes: ``steps`` greedy decode steps of
    request ``name`` under torch.profiler (after one unprofiled step),
    device time summed by kernel group per step, and the device's idle
    share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    b, prompt, max_length = REQUESTS[name]
    ids = torch.randint(0, model.config.vocab_size, (b, prompt),
                        generator=gen, device="cuda")
    with torch.inference_mode():
        caches = model.allocate_kv_caches(b, max_length)
        logits, _ = model(ids, kv_caches=caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        logits, _ = model(tok, kv_caches=caches, seqlen_offset=prompt)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        # device activity only: tracing every host-side op would slow the
        # host down and inflate the idle share
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, steps + 1):
                logits, _ = model(tok, kv_caches=caches,
                                  seqlen_offset=prompt + i)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        kernels.append((ms, e.key))
    busy = sum(groups.values())
    out = {"request": name, "steps": steps,
           "wall_ms_per_step_profiled": wall_ms / steps,
           "device_ms_per_step": {g: v / steps for g, v in sorted(
               groups.items(), key=lambda kv: -kv[1])},
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "top_kernels_ms_per_step": [
               [k[:80], ms / steps] for ms, k in sorted(kernels)[::-1][:6]]}
    print(f"  decode step breakdown: {json.dumps(out)}", flush=True)
    if not busy:
        print("  the profiler saw no device time: breakdown not measured",
              flush=True)
    return out


def tiny_parity():
    """A tiny model on the card (bf16 kernels) against the same weights on
    the CPU in fp32 (plain versions): prefill and teacher-forced decode
    logits, for a prompt <= 1024 and one > 1024."""
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, decode, llama_config_to_gpt_config)
    hf = types.SimpleNamespace(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5)
    cpu = GPTLMHeadModel(llama_config_to_gpt_config(hf), device="cpu")
    gpu = GPTLMHeadModel(llama_config_to_gpt_config(hf, torch.bfloat16),
                         device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    for prompt, max_length in ((40, 48), (1030, 1036)):
        ids = torch.randint(0, 512, (2, prompt), generator=g)
        seq, ref = decode(cpu, ids, max_length, return_scores=True)
        _, got = decode(gpu, ids, max_length, teacher_outputs=seq,
                        return_scores=True)
        err = max_err(got.cpu(), ref)
        tol = 0.05 * ref.abs().max().item()
        print(f"  tiny model, prompt {prompt}: max |cuda bf16 - cpu fp32| "
              f"logit {err:.4g} (tol {tol:.4g})", flush=True)
        check(err <= tol, f"tiny model prompt {prompt}: {err} > {tol}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, llama_config_to_gpt_config)
    from xhy_flash_attention_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    check(torch.cuda.get_device_capability(0) == (9, 0),
          "the kernels are built for sm_90a")

    t0 = time.perf_counter()
    print("[2] build", flush=True)
    _cuda.build(verbose=True)
    _cuda.lib()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] kernels against their plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [check_norm(gen), check_flash_fwd(gen), check_fused_heads(gen),
            check_decode(gen, "A")]
    check_decode(gen, "B")  # printed; the JSON line keeps request A's row
    torch.cuda.empty_cache()

    print(f"[4] slice: Llama-3-8B width, {LAYERS} layers, random bf16 "
          "weights", flush=True)
    t0 = time.perf_counter()
    model = GPTLMHeadModel(
        llama_config_to_gpt_config(types.SimpleNamespace(**LLAMA3_8B),
                                   torch.bfloat16), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params / 1e9:.3f} B parameters built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    totals = {name: 0 for name in counters()}
    for name in REQUESTS:
        counts, _ = serve(model, gen, name)
        for k, v in counts.items():
            totals[k] += v
    check(all(v > 0 for v in totals.values()),
          f"a kernel of the path never launched: {totals}")
    print("[5] the kernel path against the plain path, full width and depth",
          flush=True)
    for name in REQUESTS:
        kernel_vs_plain(model, gen, name)
    torch.cuda.empty_cache()
    print("[6] where the time goes", flush=True)
    for name in REQUESTS:
        decode_breakdown(model, gen, name)
    del model
    torch.cuda.empty_cache()
    print("[7] tiny model: the card (bf16) against the CPU (fp32)",
          flush=True)
    tiny_parity()

    for row in rows:
        row["launches"] = totals[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
