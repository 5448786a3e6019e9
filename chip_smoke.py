#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py    # Llama-3-8B and Mistral-7B serving (bf16,
                             # int8 and int4 weights), GPT-2 XL serving in
                             # fp32, GPT-3/GPT-2-medium training (8k with
                             # remat; fp32, fp32 on packed documents), fp8
                             # prefill, fp32 attention with a bias,
                             # GPT-2 medium with attention and residual
                             # dropout, GPT-NeoX at Pythia-6.9B widths,
                             # full width and depth, one card

Phases (any failure raises and exits non-zero, with no "ok" line):
  1. the card: name and power limit (nvidia-smi), capability (9, 0);
  2. build: every CUDA kernel of xhy_flash_attention_tpu_torch/csrc is
     compiled from source (ptxas report printed);
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the serving path gives it, with max error, tolerance and times
     (kernel, plain version, one PyTorch library call, roofline bound);
     the dense forward (#1, #5) at requests A and B and at T-long's
     attention (b16 h16 s2048 d64), with its TFLOP/s and share of the
     bound, the kernel and SDPA timed as CUDA graphs of calls;
     the decode kernels also at the JAX package's headline decode shape
     (b8 h32 hk8 d128 S8192, bf16 / int8 / e4m3), with their cluster plan
     and the time of each cluster size, all timed as CUDA graphs of calls
     (their wrappers take longer on the host than the kernels on the card);
     the paged kernel (#10, #11) at the engine's decode and chunked-prefill
     shapes, timed the same way, with its launch plan (regime, cluster,
     CTAs), two calls bitwise equal, and at the bf16 decode row the time of
     each cluster size;
  4. the slice: random bf16 weights at Llama-3-8B width serve request A
     (batch 2, prompt 2048, max_length 2080) and request B (batch 2,
     prompt 960, max_length 1024) through `decode`, its step replayed as a
     CUDA graph (the main path) and, for comparison, uncaptured
     (cuda_graph=False): ms/step and tok/s of both, graph tokens equal to
     eager tokens, launch counts of every kernel checked exactly (the
     wrappers count a captured launch once: captured launches times
     replays are added), and a second prefill over prompt + generated
     tokens checked against the graph's decode-step logits; then (4b) 12
     requests through `InferenceEngine` (bf16 and INT8 pages, chunked
     prefill), its decode step a graph and uncaptured, the same way;
  5. the kernel path against the plain path at full width and depth: the
     prefill and one decode step of each request, once through the
     kernels and once through their plain versions on the same tensors
     and caches;
  6. where the time goes: decode steps of each request and of the engine
     at batch 8, uncaptured and as a CUDA graph, under torch.profiler
     (device time and kernels by group, the idle share) and between CUDA
     events (the graph's span per step); and two chunked-prefill steps of
     the engine (eager);
  7. a tiny model on the card against the fp32 plain path on the CPU;
  8. training (slice 3): the repository's recipes T-long
     (experiment/pile/gpt3m-flash.yaml: seqlen 2048, rotary) and T-packed
     (experiment/owt/gpt2m-flash.yaml: seqlen 1024, learned positions),
     each for 6 steps through `train(config_path, **overrides)` on a token
     file written from the seed, at full width, depth and batch; per-step
     loss, grad norm, step ms, tokens/s, MFU and exact launch counts, and
     no call of any plain version;
  9. one training step of each recipe at depth 2 through the kernels and
     through the plain versions: the loss and every parameter's gradient;
 10. where a training step's device time goes, by kernel group;
 11. sparse masks (slice 4) at full width, data from --seed, through
     `flashmask_attention`, `blocksparse_attention` and
     `calc_reduced_attn_scores`, forward and backward: FM-doc (b16 h16 s2048
     d64, the gpt3m-flash.yaml attention, a causal document mask with
     document lengths in 128-1024), FM-swg (Llama-3-8B width b1 h32 hk8
     s8192 d128, global_sliding_window_mask(1024, 64), then the reduced
     scores of its LSE), FM-full (b2 h16 s2048 d64, full_2 and full_4 with
     random bands, 4 mask heads), BS (b16 h16 s2048 d64, a BigBird-like
     block mask at granularity 256); launches exact, the error against the
     fp32 plain version at most twice the bf16 plain version's, a second
     pass bitwise equal;
 12. Mistral-7B width (hidden 4096, 32 layers, 32/8 heads, d 128, vocab
     32000, sliding window 4096; random bf16 weights from --seed) serves
     request W (batch 2, prompt 8192, 32 decode steps) through `decode`,
     graph and uncaptured: the prefill through the windowed forward (32
     launches), graph tokens equal to eager tokens, the kernel path
     against the plain path (attention by kv-head groups) on the prefill
     and one decode step, and the window binding the last position's
     logits (the same weights without it differ by more than the gate);
 13. varlen and windowed attention, forward and backward through the
     public entries: VL-doc (`flash_attn_varlen_func`, h16 d64, 32768
     tokens of documents of 128-2048), VL-gqa
     (`flash_attn_varlen_kvpacked_func`, h32 hk8 d128, 16384 tokens of
     documents of 512-4096), SW (`flash_attn_func`, b1 h32 hk8 s8192 d128,
     window (4095, 0)); launches exact, the 2x contract against the fp32
     and bf16 plain versions, a second pass bitwise equal; times beside
     SDPA with the dense mask and, for VL-doc, the FlashMask route on the
     same documents;
 14. attention bias with dbias through `flash_attention(q, k, v, bias)`,
     bias.requires_grad, causal: Llama-3-8B width's attention (b2 h32 hk8
     s2048 d128) with a shared (1, 1, s, s), an attn_mask (b, 1, s, s) and
     a per-head (b, h, s, s) fp32 bias, and T-long's (b16 h16 s2048 d64)
     with a (1, h, s, s) one: launches exact (the bias instantiations of
     the forward, dK/dV and dQ kernels and the dbias kernel; no plain
     version), out and every gradient within twice the bf16 plain
     version's error against the fp32 plain version, a second pass bitwise
     equal, the backward's peak memory beside the bias's size, each kernel
     timed beside the plain version and SDPA with the bias as a float mask;
     then `capi_bridge.attn_fwd` / `attn_bwd` with an attn_mask on numpy
     inputs, against the plain versions;
 15. the fp8 prefill through `flash_attn_fp8_func` (the e4m3 instantiation
     of the forward kernel) on inputs quantized by `quantize_fp8_per_head`
     (per-head magnitudes spread 30x): FP8-A (b2 h32 hk8 s2048 d128,
     causal), FP8-8k (b1 h32 hk8 s8192 d128), FP8-d64 (b16 h16 s2048 d64),
     then correctness-only a window (4095, 0) and softcap 30 at FP8-8k's
     width and odd lengths (113/203, 257): launches exact, no plain
     version, out and LSE within twice the bf16 plain version's error
     against the fp32 plain version on the dequantized inputs and against
     the kernel's own plain version within the limits on the e4m3
     wgmma's accumulation error (`reference.fp8_ref_errors`), a second
     call bitwise equal; the timed cases beside their bound (QK^T's FLOPs
     at 1979e12, P.V's at 989e12, visible pairs), the plain version, SDPA
     in bf16 on the dequantized inputs and the port's bf16 #1;
 16. T-8k: `train("experiment/pile/gpt3m-flash-8k.yaml")` at full width,
     depth and batch (24 layers, hidden 1024, seqlen 8192, batch 2) for 6
     steps under the recipe's remat (save_attn), then 2 steps each with
     remat_policy "save_dots" and "nothing" and without remat: step ms,
     tokens/s, MFU,
     peak memory, exact launches (the attention forward once a layer a step
     under save_attn, twice under "nothing"), no plain version; at depth 2
     the loss and every gradient with remat against without;
 17. weight-only serving at Llama-3-8B width: phase 4's random bf16
     weights through `quantize_gpt_params` as int8 and as int4 serve
     request A (graph and uncaptured, as phase 4), the kernel path against
     the plain path (phase 5's gate), a profiled decode step, the logits
     against the bf16 model (printed); the engine's 12 requests with int8
     weights and bf16 pages; ms/step, tok/s, peak memory and weight bytes
     beside the bf16 model's;
 18. cell G: GPT-2 XL (openai-community/gpt2-xl widths: hidden 1600, 48
     layers, 25 heads of 64, 1024 positions, vocab 50257, gelu_new, the
     three pdrops 0.1) in fp32, its random weights under Hugging Face's
     key names through `gpt2_config_to_gpt_config` and
     `remap_state_dict_hf_gpt2`: request G (batch 4, prompt 896,
     max_length 1024) through `decode`, graph and uncaptured, exact
     launches; the prefill and one decode step through the kernels, the
     fp32 plain versions and float64 plain versions (the gate: the
     kernels' distance from float64 at most twice the fp32 plain path's
     plus 1e-4 of the largest logit); the caches through
     `flash_attn_with_kvcache(num_splits=3)`; 12 requests through
     InferenceEngine on fp32 pages (prompts 128-896, chunked prefill, the
     decode step a graph, its tokens equal to the uncaptured engine's);
 19. cell T-packed-fp32: `train("experiment/owt/gpt2m-flash.yaml",
     dtype="float32")` at full width and depth for 4 steps at the largest
     batch of 32, 16, 8 that fits (a smaller one printed as a cut): step
     ms, tokens/s, peak memory, exact launches of fp32 #5 / #6 and the
     pre-pass, no plain version; phase 10's table for one more step
     (device ms by group, the idle share); at depth 2 the loss and every
     gradient through the kernels, the fp32 and the float64 plain versions
     under phase 18's gate;
 20. cell T-doc-fp32: `gpt2m-flash.yaml` in fp32 at full width, depth and
     batch, each row packed with documents of 128-1024 tokens drawn from
     the seed, passed as `segment_ids` to the model (the unpacked route:
     the masked fp32 #1, #2 and #3 on every layer), 4 AdamW steps through
     the Trainer: step ms, tokens/s, exact launches, no plain version;
     phase 10's table for one more step; depth 2 against the fp32 and
     float64 plain paths under phase 18's gate;
 21. fp32 with an attention bias through `flash_attention(q, k, v, bias,
     causal=True)`, q, k, v and bias.requires_grad (the BIAS
     instantiations of the fp32 forward, dK/dV and dQ kernels and the fp32
     dbias kernel): G-pad (GPT-2 XL's attention b4 h25 s1024 d64, an
     attn_mask (b, 1, s, s) of -1e4 past each row's length, lengths
     512-1024 from the seed), G-alibi (the same, ALiBi (1, h, s, s) with
     BLOOM's slopes for 25 heads), L-shared (Llama-3-8B's b2 h32 hk8 s2048
     d128, a shared (1, 1, s, s) bias), L-bh (the same, a (b, h, s, s)
     bias of 1.07 GB), G-bf16bias (a bf16 bias, dbias bf16; correctness
     only), then `capi_bridge.attn_fwd` / `attn_bwd` on float32 numpy at
     G-pad: exact launches (no plain version, no bf16 kernel), out, LSE
     and every gradient against float64 on all of it (by (batch, kv-group)
     chunks) under phase 18's gate, dq, dk, dv and dbias bitwise equal
     over three backward passes; each kernel timed beside its bound (3
     TF32 products at 495 TFLOP/s; bytes with the bias's causal part read
     and dbias written), the plain versions and SDPA fp32 with the bias
     and the causal mask as a float mask (TF32 off);
 22. attention dropout (p 0.1, the dropout instantiations of #1, #2 and
     #3): the keep mask each kernel applies read back bit for bit against
     `common.dropout_keep_mask` (q = 0 so that P is uniform; V, dO or K
     one-hot on windows of d keys or rows; d 64 and 128, dense and masked
     (a block mask, causal with sq != sk), seeds 0, 77, -3, p 0.1, 0.5,
     0.9); #1, #2 and #3 at A (Llama-3-8B's attention, d 128), T-long
     (d 64) and FM-doc (its causal document FlashMask: the masked
     instantiations), #5 / #6 at T-packed: against their plain versions
     (a batch
     row at a time), the 2x contract under the same keep mask, three
     backward passes bitwise equal, each timed beside itself without
     dropout, its bound (products, bytes and the integer floor of the hash,
     HASH_OPS a hashed pair) and SDPA with dropout_p 0.1; then GPT-2 medium
     (openai-community/gpt2-medium widths, attn_pdrop 0.1, embd_pdrop and
     resid_pdrop cut to 0: the JAX model raises on them) from random bf16
     weights at gpt2m-flash.yaml's batch 32 x 1024 for 3 steps of
     deterministic=False forward, cross-entropy, backward and the recipe's
     AdamW on the packed route: exact launches (each layer's dropout
     instantiations of #5, #6), no plain version, finite losses, step 1
     repeated with the same seeds bitwise equal (loss and every gradient),
     another seed different, and at depth 2 the kernels against the plain
     versions under the same seeds (phase 9's limits);
 23. T-drop-resid: GPT-2 medium's widths with its published embd_pdrop,
     resid_pdrop and attn_pdrop (0.1), its 24 Blocks built by the port's
     GPTLMHeadModel as the JAX GPTModel builds them and driven with
     deterministic=False and explicit seeds (norm1, norm2 and the
     attention's, drawn per block and step from a generator; the JAX
     model's own forward refuses residual dropout), the embedding, the
     final norm (no dropout) and the tied head around them, random bf16
     weights, batch 32 x 1024, 3 AdamW steps: exact launches (the fused
     norm's dropout-only LayerNorm instantiation 2 a block forward and 2
     backward), no
     plain version, a repeat bitwise equal, depth 2 against the plain
     versions; step ms beside phase 22's T-drop; then
     `dropout_add_layer_norm` at T-long's norm and `dropout_add_rms_norm`
     at Llama-3-8B width with p 0.1, a rowscale and a layerscale, forward
     and backward through the entries;
 24. NeoX-6.9B: GPT-NeoX at EleutherAI/pythia-6.9b's widths (hidden 4096,
     32 layers, 32 heads of 128, intermediate 16384, rotary_pct 0.25,
     vocab 50432, parallel residual, untied embeddings) through
     `gpt_neox_config_to_gpt_config`, random bf16 weights at full depth:
     request N (batch 2, prompt 1024, 64 new tokens) through `decode`,
     eager and as a CUDA graph (prefill tok/s, decode ms/step, graph tokens
     equal to eager tokens, exact launches), then the kernel path against
     the plain path on the prefill and one decode step (phase 5's bounds).
Phase 3 also holds #7 and #8 with dropout (p 0.1), a rowscale and a
layerscale at T-long's norm (32768 x 1024 LayerNorm) and Llama-3-8B width
(4096 x 4096 RMSNorm), and with dropout alone at T-drop-resid's norm
(32768 x 1024 LayerNorm), prenorm with bf16 x0 and an fp32 residual: the keep
mask bit for bit (residual_out with x0 = 1, residual 0 and unit scales;
dx0's zeros), every output within twice the bf16 plain version's error
against the fp32 plain version, dgamma / dbeta / dcolscale bitwise equal
over three runs, each timed beside its no-flag twin, the plain version and
the composed library calls, bound by bytes or the hash's integer floor;
each row's launches are its own instantiation's on phase 23's paths.
Phases 11 and 13 also drive FM-doc, FM-swg (with the reduced scores of its
LSE), BS and VL-doc in fp32 through the same entries (the masked fp32
kernels; exact launches, within 1e-4 of the fp32 plain version's largest
entries, a second pass bitwise equal).
Phase 3 also holds the masked fp32 kernels at FM-doc, BS, FM-swg
and VL-doc in fp32: out, LSE and every gradient against float64 on a
subset (batch 0, whole kv-head groups, a token prefix no visible pair
crosses) within twice the fp32 plain version's error plus 1e-4, against
the fp32 plain version on all of it, three backward passes bitwise equal,
the tiles they visit against the fp32 mirrors, bound by 3 TF32 products
over the visible pairs, SDPA fp32 with the dense mask beside; and #12 in
fp32 on FM-swg-fp32's LSE (against float64 under phase 18's gate, bound
by the larger of the products and the exponent units' floor).
Phase 3 also holds the fp32 kernels (csrc/flash_fp32.cu, the pre-pass's
fp32 instantiation and the fp32 decode paths): #1 at G's prefill and #5 at
T-packed's attention, the whole backward at both shapes (three passes
bitwise equal; beside each output's and gradient's error against float64
that of reference.py's emulation of the three TF32 products), #4 and #9 on fp32
caches at G's decode shape, #10 / #11 on fp32 pages at G's and at the
Llama-3-8B engine's shapes (decode and chunked prefill at sq 512); out and
every gradient against float64 within twice the fp32 plain version's error
plus 1e-4, the decode paths against their plain versions within 1e-5 of the
largest output; SDPA in fp32 (TF32 off, printed) beside each with its own
error; bound max(3 FLOPs / 495e12, bytes / 3.35e12).
Phase 3 also holds the backward kernels (the attention backward's
pre-pass, dK/dV and dQ at T-long's and at Llama-3-8B width's attention,
the packed dqkv entry at T-packed's, the norm backward) and the
sparse-mask kernels (the forward and both backward kernels under FM-doc's,
BS's and FM-swg's masks, under SW's window and VL-doc's segment ids and
positions, the reduced-scores kernel at FM-swg's shape, with
the exponent units' floor beside the bound) against their plain versions,
prints each whole attention backward against SDPA's backward, checks that
three attention backward passes are bitwise equal at each of the three
dense shapes, and prints for each mask the tiles the masked forward and
backward kernels visit, as their producers count them, checked against
fwd.py's and bwd.py's mirrors.
The last lines: the card, one JSON object with a row per kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
TENSOR_CLOCK_HZ = 1.83e9   # the clock of the bf16 peak: 4096 FLOP a clock an SM
SFU_EX2_PER_CLOCK = 16     # ex2 results a clock per SM (compute capability 9.0)
BF16_ULP = 2.0 ** -7       # one bf16 unit in the last place, relative

LLAMA3_8B = dict(  # meta-llama/Meta-Llama-3-8B config.json
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
MISTRAL_7B = dict(  # mistralai/Mistral-7B-v0.1 config.json
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    sliding_window=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
    tie_word_embeddings=False)
PYTHIA_6_9B = dict(  # EleutherAI/pythia-6.9b config.json
    vocab_size=50432, hidden_size=4096, intermediate_size=16384,
    num_hidden_layers=32, num_attention_heads=32, rotary_pct=0.25,
    rotary_emb_base=10000, max_position_embeddings=2048, layer_norm_eps=1e-5,
    hidden_act="gelu", use_parallel_residual=True, tie_word_embeddings=False,
    initializer_range=0.02)
LAYERS = LLAMA3_8B["num_hidden_layers"]
assert MISTRAL_7B["num_hidden_layers"] == LAYERS
assert PYTHIA_6_9B["num_hidden_layers"] == LAYERS
REQUESTS = {"A": (2, 2048, 2080), "B": (2, 960, 1024)}  # batch, prompt, max_length
# request W of the Mistral-7B model (phase 12): a prompt of twice the window
MISTRAL_REQUESTS = {"W": (2, 8192, 8224)}
# request N of the Pythia-6.9B-width model (phase 24)
NEOX_REQUESTS = {"N": (2, 1024, 1088)}
ALL_REQUESTS = {**REQUESTS, **MISTRAL_REQUESTS, **NEOX_REQUESTS}


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


ROW_ABS = 1e-4  # absolute term of the per-row tolerance (row_excess)


def row_excess(out, ref, abs_tol=ROW_ABS) -> float:
    """The largest ratio, over rows (the last dimension), of a row's error
    to that row's own tolerance: two bf16 units of its largest |ref| plus
    ``abs_tol``, and never more than one unit of the whole output's largest
    |ref| plus 1e-3. Above 1, a row is out of its tolerance. Two units: the
    two sides round their outputs to bf16 (one unit between them), and P
    (times v_scale) is rounded to bf16 at the running max in a kernel but
    at the row's max in the plain version (up to one more unit where a few
    keys carry the row). Unlike one tolerance from the largest output of
    the whole tensor, it holds rows that average thousands of keys (small
    outputs) as tightly as rows that see a few."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    tol = (2 * BF16_ULP * r.abs().amax(-1) + abs_tol).clamp_max(
        BF16_ULP * r.abs().max() + 1e-3)
    return ((o - r).abs().amax(-1) / tol).max().item()


def report(row: dict, extra: str) -> None:
    lib = row["library_ms"]
    print(f"  {row['name']}: max_abs_err {row['max_abs_err']:.3g} "
          f"({extra}); ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
          f"library_ms {'-' if lib is None else f'{lib:.4f}'}, bound_ms "
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


def _packed_qkv(gen, b, s, h, hk, d):
    """q, k, v as (b, s, heads, d) views of one packed Wqkv output, the
    projection layout of the serving and training paths (sequence stride
    (h + 2 hk) d)."""
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                      device="cuda").bfloat16()
    q = qkv[..., : h * d].view(b, s, h, d)
    k = qkv[..., h * d: (h + hk) * d].view(b, s, hk, d)
    v = qkv[..., (h + hk) * d:].view(b, s, hk, d)
    return q, k, v, (b, h, hk, s, d)


def _qkv(gen, b, s):
    c = LLAMA3_8B
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    return _packed_qkv(gen, b, s, h, hk, c["hidden_size"] // h)


def _attn_flops_bytes(b, h, hk, s, d):
    flops = 4.0 * b * h * s * s * d / 2  # causal, as bench.py:92 counts
    nbytes = 2.0 * b * s * d * (2 * h + 2 * hk)  # q, k, v in; o out
    return flops, nbytes


def _fwd_rate(row, flops):
    return (f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound")


def check_flash_fwd(gen, label="A"):
    """#1 through flash_attention_fwd on (b, h, s, d) views of the packed
    projection layout: at request A's shape (Llama-3-8B width) or at
    T-long's (the gpt3m-flash.yaml attention, d 64). ms and library_ms are
    device times of CUDA graphs of calls (graph_ms), as the decode rows."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    if label == "A":
        q, k, v, (b, h, hk, s, d) = _qkv(gen, *REQUESTS["A"][:2])
    else:
        q, k, v, (b, h, hk, s, d) = _packed_qkv(
            gen, T_LONG["b"], T_LONG["s"], T_LONG["h"], T_LONG["hk"],
            T_LONG["d"])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    ref, ref_lse = fwd.attention_fwd_ref(qt, kt, vt, need_lse=True, **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    err_lse = max_err(lse, ref_lse)
    del ref, ref_lse
    check(err_lse <= 1e-3, f"flash_fwd ({label}) lse err {err_lse}")
    e, e_lp = _attn_contract(out.transpose(1, 2), q, k, v, True)
    flops, nbytes = _attn_flops_bytes(b, h, hk, s, d)
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    name = "flash_fwd (flash_attention_fwd)"
    row = dict(
        name=name if label == "A" else f"{name[:-1]}, {label})",
        kernel=name, route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78",
        max_abs_err=err,
        ms=graph_ms([lambda: fwd.flash_attention_fwd(
            qt, kt, vt, need_lse=True, **kw)]),
        plain_ms=time_ms([lambda: fwd.attention_fwd_ref(
            qt, kt, vt, need_lse=False, **kw)], iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)]))
    report(row, f"vs fp32 attention_ref {e:.3g} <= 2 x bf16 baseline "
                f"{e_lp:.3g}; lse err {err_lse:.3g} <= 1e-3; {label}: b{b} "
                f"h{h} hk{hk} s{s} d{d} causal, flops {flops:.4g}, bytes "
                f"{nbytes:.4g}; {_fwd_rate(row, flops)}; ms and library_ms "
                "from CUDA graphs")
    return row


def check_fused_heads(gen):
    """#5 through fused_heads_fwd at request B's shape, with its LSE; ms
    and library_ms from CUDA graphs (the call takes about as long on the
    host as the kernel on the card)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads
    b, s, _ = REQUESTS["B"]
    q, k, v, (b, h, hk, s, d) = _qkv(gen, b, s)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fused_heads.fused_heads_fwd(q, k, v, need_lse=True, **kw)
    ref, ref_lse = fused_heads.fused_heads_fwd_ref(q, k, v, need_lse=True,
                                                   **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    err_lse = max_err(lse, ref_lse)
    check(err_lse <= 1e-3, f"flash_fwd (fused_heads) lse err {err_lse}")
    e, e_lp = _attn_contract(out, q, k, v, True)
    flops, nbytes = _attn_flops_bytes(b, h, hk, s, d)
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = dict(
        name="flash_fwd (fused_heads)", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:59",
        max_abs_err=err,
        ms=graph_ms([lambda: fused_heads.fused_heads_fwd(q, k, v, **kw)]),
        plain_ms=time_ms([lambda: fused_heads.fused_heads_fwd_ref(
            q, k, v, **kw)], iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)]))
    report(row, f"vs fp32 attention_ref {e:.3g} <= 2 x bf16 baseline "
                f"{e_lp:.3g}; lse err {err_lse:.3g} <= 1e-3; packed layout "
                f"b{b} s{s} h{h} hk{hk} d{d} causal, flops {flops:.4g}, "
                f"bytes {nbytes:.4g}; {_fwd_rate(row, flops)}; ms and "
                "library_ms from CUDA graphs")
    return row


def graph_ms(fns, reps: int = 10, replays: int = 20) -> float:
    """Mean device time of one call, cycling over ``fns``, with the calls
    captured in one CUDA graph: the decode kernels take less time on the
    card than their wrappers take on the host, and launched one by one they
    would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the graph
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


QUANT = (torch.int8, torch.float8_e4m3fn)
SHORT = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float8_e4m3fn: "e4m3",
         torch.float32: "fp32"}
DECODE_SHAPES = {  # batch, cache length
    "A": (REQUESTS["A"][0], REQUESTS["A"][2]),
    "B": (REQUESTS["B"][0], REQUESTS["B"][2]),
    # the JAX package's headline decode shape (bench.py:139)
    "b8 S8192": (8, 8192),
}


def _dense_sets(gen, b, hk, S, d, dtype, min_bytes=128e6):
    """Enough (k, v) cache copies, bf16 or QuantizedKV, that together they
    exceed the 50 MB L2."""
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    elem = 2 if dtype == torch.bfloat16 else 1 + 4 / d
    n_sets = max(1, math.ceil(min_bytes / (2 * b * hk * S * d * elem)))
    sets = []
    for _ in range(n_sets):
        kv = [torch.randn(b, hk, S, d, generator=gen, device="cuda")
              for _ in range(2)]
        sets.append([quantize_kv(x, dtype) if dtype in QUANT else x.bfloat16()
                     for x in kv])
    return sets, elem


def _bf16_caches(sets, dtype):
    """The caches as SDPA takes them: bf16, dequantized for 1-byte ones."""
    if dtype not in QUANT:
        return sets
    return [[x.values.float().mul(x.scales).bfloat16() for x in kv]
            for kv in sets]


def _plan_text(q, kc, splits=1, split_len=0):
    """The cluster size, CTAs and the card's room for such clusters."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    b, hk, S = q.shape[0], dk._payload(kc)[0].shape[1], dk._payload(kc)[0].shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster, chunk = dk.decode_launch_plan(b, hk, S, splits, split_len, sms)
    room = dk.max_active_clusters(q, kc, cluster, partial=splits > 1)
    return (f"cluster {cluster} x {b * hk * splits} = "
            f"{cluster * b * hk * splits} CTAs, chunk {chunk} keys, "
            f"{room} clusters fit at once")


def check_decode(gen, shape: str, dtype=torch.bfloat16):
    """flash_decode at a serving shape's last decode step (bf16 cache, or an
    int8 / e4m3 QuantizedKV); at bf16 also the time with each cluster size
    forced."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    c = LLAMA3_8B
    b, S = DECODE_SHAPES[shape]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    sets, elem = _dense_sets(gen, b, hk, S, d, dtype)
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    kc, vc = sets[0]
    # ragged lengths first (length handling), then the last step's lengths
    lengths = torch.full((b,), S, dtype=torch.int32, device="cuda")
    ragged = lengths.clone()
    ragged[1::2] -= 29
    err = max(max_err(dk.flash_decode(q, kc, vc, ln, softmax_scale=scale),
                      dk.flash_decode_ref(q, kc, vc, ln, scale))
              for ln in (ragged, lengths))
    ref = dk.flash_decode_ref(q, kc, vc, lengths, scale)
    torch.cuda.synchronize()
    tol = BF16_ULP * ref.float().abs().max().item() + 1e-6
    name = "flash_decode" + ("" if dtype == torch.bfloat16
                             else f" ({SHORT[dtype]})")
    check(err <= tol, f"{name} at {shape} err {err} > {tol}")
    n_tok = int(lengths.sum().item())
    # the cache positions read (k and v, with their scales), q in and out
    nbytes = 2.0 * hk * n_tok * d * elem + 2 * 2.0 * b * h * d
    flops = 4.0 * h * n_tok * d  # q.k and p.v for every head
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    lib = _bf16_caches(sets, dtype)
    row = dict(
        name=name, route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_decode.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/decode_kernel.py:47",
        max_abs_err=err,
        ms=graph_ms([lambda kc=kc, vc=vc: dk.flash_decode(
            q, kc, vc, lengths, softmax_scale=scale) for kc, vc in sets]),
        plain_ms=graph_ms([lambda: dk.flash_decode_ref(
            q, kc, vc, lengths, scale)], reps=2, replays=5),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, enable_gqa=True) for kc, vc in lib]))
    report(row, f"{shape} last step, {SHORT[dtype]} cache: tol {tol:.3g} = 1 "
                f"bf16 ulp of max|out|; b{b} h{h} hk{hk} len {S} d{d}, flops "
                f"{flops:.4g}, bytes {nbytes:.4g}, {len(sets)} cache copies "
                f"rotated; {_plan_text(q, kc)}; times of CUDA graphs of "
                "calls; library: SDPA on the bf16"
                f"{' (dequantized)' if dtype in QUANT else ''} caches")
    if dtype == torch.bfloat16:
        out = torch.empty_like(q)
        by_cluster = {cl: graph_ms([lambda kc=kc, vc=vc, cl=cl: dk.launch_decode(
            q, kc, vc, lengths, softmax_scale=scale, out=out, cluster=cl)
            for kc, vc in sets]) for cl in dk.CLUSTER_SIZES}
        print(f"    ms by cluster size: {json.dumps(by_cluster)}", flush=True)
    del sets, lib
    return row


def splitkv_plain(q, kc, vc, lengths, scale, splits, split_len):
    """The plain version of flash_decode_splitkv: partials, then the merge."""
    from xhy_flash_attention_tpu_torch.inference import combine
    outs, ms, ls = combine.splitkv_partials_ref(q, kc, vc, lengths, scale,
                                                splits, split_len)
    return combine.merge_attention_partials(outs, ms[..., None],
                                            ls[..., None], axis=2)[0]


def check_splitkv(gen, dtype, decode_ms):
    """flash_decode_splitkv at request A's last decode step with the
    heuristic's split count, beside flash_decode's time at that shape."""
    from xhy_flash_attention_tpu_torch.inference import combine
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    c = LLAMA3_8B
    b, S = DECODE_SHAPES["A"]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    sets, elem = _dense_sets(gen, b, hk, S, d, dtype)
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    lengths = torch.full((b,), S, dtype=torch.int32, device="cuda")
    ragged = torch.tensor([S, 700], dtype=torch.int32, device="cuda")
    kc, vc = sets[0]
    scale = d ** -0.5
    splits, split_len = combine._split_plan(q, kc, 0, 512)
    err = max(max_err(combine.flash_decode_splitkv(q, kc, vc, ln),
                      dk.flash_decode_ref(q, kc, vc, ln, scale))
              for ln in (ragged, lengths))
    ref = dk.flash_decode_ref(q, kc, vc, lengths, scale)
    torch.cuda.synchronize()
    tol = BF16_ULP * ref.float().abs().max().item() + 1e-6
    check(err <= tol, f"flash_decode_splitkv {SHORT[dtype]} err {err} > {tol}")
    nbytes = 2.0 * b * hk * S * d * elem + 2 * 2.0 * b * h * d
    flops = 4.0 * b * h * S * d
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    lib = _bf16_caches(sets, dtype)
    row = dict(
        name=f"flash_decode_splitkv ({SHORT[dtype]})", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_decode.cu",
        replaces="xhy_flash_attention_tpu/inference/combine.py:75",
        max_abs_err=err,
        ms=graph_ms([lambda kc=kc, vc=vc: combine.flash_decode_splitkv(
            q, kc, vc, lengths) for kc, vc in sets]),
        plain_ms=graph_ms([lambda: splitkv_plain(q, kc, vc, lengths, scale,
                                                 splits, split_len)],
                          reps=2, replays=5),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, enable_gqa=True) for kc, vc in lib]))
    report(row, f"request A last step, {splits} splits of {split_len} keys "
                f"(heuristic, {torch.cuda.get_device_properties(0).multi_processor_count}"
                f" SMs) beside flash_decode (bf16, one split) {decode_ms:.4f} "
                f"ms: tol {tol:.3g}; b{b} h{h} hk{hk} len {S} d{d}, bytes "
                f"{nbytes:.4g}; {_plan_text(q, kc, splits, split_len)}; ms "
                "includes the merge; times of CUDA graphs of calls")
    del sets, lib
    return row


ENGINE_DECODE = dict(b=8, h=32, hk=8, d=128,
                     lengths=[4096, 3000, 2048, 1500, 1024, 700, 300, 0])


def _paged_sets(gen, dtype, ps, npp, n_sets=3):
    """``n_sets`` paged caches at the engine's decode shape over one pool
    of pages, each sequence's pages taken in a shuffled order from the
    seed; the sets' pages are disjoint and exceed L2 together. int8 / e4m3
    pages carry the linear scales of their own quantization."""
    from xhy_flash_attention_tpu_torch.inference.paged import PagedKVCache
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    c = ENGINE_DECODE
    b, hk, d = c["b"], c["hk"], c["d"]
    P = n_sets * b * npp + 1
    kv = torch.randn(P, hk, 2, ps, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    page_scales = None
    if dtype in QUANT:
        qkv = quantize_kv(kv, dtype)
        kv, page_scales = qkv.values, qkv.scales[..., 0]
    perm = torch.randperm(P - 1, generator=gen, device="cuda")
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
    sets = []
    for i in range(n_sets):
        table = perm[i * b * npp:(i + 1) * b * npp].reshape(b, npp)
        scales = None
        if page_scales is not None:
            scales = page_scales[table].permute(0, 2, 3, 1, 4).reshape(
                b, hk, 2, npp * ps).contiguous()
        sets.append(PagedKVCache(kv, table.to(torch.int32).contiguous(),
                                 lengths, scales))
    return sets


def _visible_pairs(lengths, sq, cap):
    """(query row, key) pairs that the causal paged kernels attend, per
    query head: sum over sequences and new tokens of the visible keys."""
    return sum(max(0, min(L, cap, L - sq + si + 1))
               for L in lengths for si in range(sq))


# Readings of the earlier paged kernel (one block of 64 rows per (batch, kv
# head), no split of the keys) at the same rows, timed eagerly with CUDA
# events on an H100 at 700 W (PERF.md section 6): printed beside this run's
PAGED_EARLIER_MS = {"paged_decode (chunked, bf16)": 0.5173,
                "paged_decode (chunked, int8)": 0.7088,
                "paged_decode (chunked, bf16, sq 512)": 1.3425,
                "paged_decode (page, bf16)": 0.5020}


def check_paged(gen, entry, dtype, sq=1, clusters=False):
    """One paged-decode entry at the engine's decode shape (b8 h32 hk8 d128,
    lengths 4096 ... 0): the chunked entry over pages of 512, 8 per
    sequence, the page entry over one page of 4096 per sequence. Two calls
    bitwise equal; with ``clusters`` the time of each cluster size of the
    decode regime, forced."""
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    c = ENGINE_DECODE
    b, h, hk, d = c["b"], c["h"], c["hk"], c["d"]
    ps, npp = (512, 8) if entry == "chunked" else (4096, 1)
    sets = _paged_sets(gen, dtype, ps, npp)
    fn = getattr(paged, f"paged_decode_{entry}")
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    cache = sets[0]
    before = fn.launches
    out = paged.paged_flash_decode(q, cache)
    check(fn.launches == before + 1, f"paged_flash_decode did not route to "
                                     f"the {entry} entry")
    again = paged.paged_flash_decode(q, cache)
    ref = paged.paged_flash_decode_ref(q, cache, scale)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"paged_decode ({entry}) {SHORT[dtype]} "
                                   f"sq {sq}: two calls differ")
    err = max_err(out, ref)
    excess = row_excess(out, ref)
    check(excess <= 1, f"paged_decode ({entry}) {SHORT[dtype]} sq {sq}: a "
                       f"row's error is {excess:.4g} of its tolerance")
    check(not out[-1].float().abs().any(), "the empty slot is not zero")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = paged.paged_launch_plan(b, sq, h, hk, ps, npp, sms)
    cap = ps * npp
    n_tok = sum(min(L, cap) for L in c["lengths"])
    elem = 2 if dtype == torch.bfloat16 else 1 + 4 / d
    nbytes = (2.0 * hk * n_tok * d * elem + 2 * 2.0 * b * sq * h * d
              + 4.0 * b * (npp + 1))
    flops = 4.0 * h * d * _visible_pairs(c["lengths"], sq, cap)
    bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    # library yardstick: SDPA with a mask over the dense-equivalent bf16
    # cache (pages gathered, dequantized, K/V heads repeated)
    k, v, ks, vs = paged._gather(cache)
    if ks is not None:
        k, v = k.float() * ks[..., None], v.float() * vs[..., None]
    k, v = (x.bfloat16().repeat_interleave(h // hk, dim=1) for x in (k, v))
    cols = torch.arange(cap, device="cuda")
    pos = cache.lengths.long()[:, None] - sq + torch.arange(sq, device="cuda")
    mask = (cols[None, None] <= pos[:, :, None])[:, None]
    del ref, out, again
    name = f"paged_decode ({entry}, {SHORT[dtype]}" + (
        f", sq {sq})" if sq > 1 else ")")
    eager_ms = time_ms([lambda s=s: paged.paged_flash_decode(q, s)
                        for s in sets], iters=10 * len(sets))
    row = dict(
        name=name, route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/paged_decode.cu",
        replaces=("xhy_flash_attention_tpu/inference/paged.py:219"
                  if entry == "chunked" else
                  "xhy_flash_attention_tpu/inference/paged.py:149"),
        max_abs_err=err,
        ms=graph_ms([lambda s=s: paged.paged_flash_decode(q, s) for s in sets]),
        plain_ms=time_ms([lambda: paged.paged_flash_decode_ref(
            q, cache, scale)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask)]))
    report(row, f"each row within 2 bf16 ulp of its own max|out| + "
                f"{ROW_ABS:g} (at most 1 ulp of the whole max|out| + 1e-3), "
                f"the worst at {excess:.4g} of its tolerance (P rounded to "
                f"bf16 on both sides); two calls bitwise equal; "
                f"b{b} h{h} "
                f"hk{hk} d{d} sq {sq}, pages of {ps}, {npp} per sequence, "
                f"lengths {c['lengths']}, flops {flops:.4g}, bytes "
                f"{nbytes:.4g}, {len(sets)} page tables rotated over disjoint "
                f"shuffled pages; plan {json.dumps(plan)}; ms and library_ms "
                f"of CUDA graphs of calls; eager {eager_ms:.4f} ms (CUDA "
                f"events, launches one by one); the earlier kernel "
                f"{PAGED_EARLIER_MS.get(name, 'not measured')} ms (eager); "
                "library: SDPA with a mask on the dense-equivalent bf16 cache")
    if clusters:
        by_cluster = {cl: graph_ms([lambda s=s, cl=cl: paged.launch_paged(
            q, s, softmax_scale=scale, cluster=cl) for s in sets])
            for cl in dk.CLUSTER_SIZES}
        print(f"    ms by cluster size: {json.dumps(by_cluster)}", flush=True)
    del sets, k, v, mask
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- phase 4

SERVING_KERNELS = ("rms_norm_add", "flash_fwd (flash_attention_fwd)",
                   "flash_fwd (fused_heads)", "flash_decode",
                   "flash_decode_splitkv", "paged_decode (chunked)",
                   "paged_decode (page)")
TRAINING_KERNELS = ("flash_bwd_prep", "flash_bwd_dkv", "flash_bwd_dq",
                    "fused_heads_bwd", "ln_bwd")


def counters():
    from xhy_flash_attention_tpu_torch.inference import combine, paged
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, decode_kernel, fused_heads, fwd, reduced_scores)
    from xhy_flash_attention_tpu_torch.ops import layer_norm
    return {"rms_norm_add": layer_norm.ln_fwd,
            "flash_fwd (flash_attention_fwd)": fwd.flash_attention_fwd,
            "flash_fwd (fused_heads)": fused_heads.fused_heads_fwd,
            "flash_fwd_fp8": fwd.flash_fwd_fp8,
            "flash_fwd_fp32": fwd.flash_fwd_fp32,
            "flash_decode": decode_kernel.flash_decode,
            "flash_decode_splitkv": combine.flash_decode_splitkv,
            "paged_decode (chunked)": paged.paged_decode_chunked,
            "paged_decode (page)": paged.paged_decode_page,
            "flash_bwd_prep": bwd.flash_bwd_prep,
            "flash_bwd_dkv": bwd.flash_bwd_dkv,
            "flash_bwd_dq": bwd.flash_bwd_dq,
            "flash_bwd_dkv_fp32": bwd.flash_bwd_dkv_fp32,
            "flash_bwd_dq_fp32": bwd.flash_bwd_dq_fp32,
            "flash_bwd_dbias": bwd.flash_bwd_dbias,
            "flash_bwd_dbias_fp32": bwd.flash_bwd_dbias_fp32,
            "fused_heads_bwd": fused_heads.fused_heads_bwd,
            "ln_bwd": layer_norm.ln_bwd,
            "reduced_scores": reduced_scores.calc_reduced_attn_scores}


def reset_counts():
    from xhy_flash_attention_tpu_torch.utils.generation import CUDAGraphStep
    for fn in counters().values():
        fn.launches = 0
    CUDAGraphStep.captures = CUDAGraphStep.replays = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def read_graph_counts():
    """(graphs captured, replays) since the last reset_counts()."""
    from xhy_flash_attention_tpu_torch.utils.generation import CUDAGraphStep
    return CUDAGraphStep.captures, CUDAGraphStep.replays


def decode_launches(what, prompt: int, max_length: int,
                    expect=None):
    """The launches of the decode() run just made through its graph,
    checked against the eager count, ``expect(prompt, max_length)``
    (expected_counts, the Llama-3-8B model's, by default)."""
    expect = expect or expected_counts
    want = expect(prompt, max_length)
    counts, replays = replayed_launches(
        what, read_counts(), read_graph_counts(),
        expect(prompt, prompt + 1),
        {k: want[k] - expect(prompt, max_length - 1)[k] for k in want})
    check(counts == want, f"{what}: launches {counts} != {want}")
    check(replays == max_length - prompt - 1,
          f"{what}: {replays} replays for {max_length - prompt} steps")
    return counts


def replayed_launches(what, counts, graphs, before_capture, one_step):
    """The launches that a run made on the card when its steps replayed one
    CUDA graph. A wrapper counts a launch where it issues it, so the
    captured step moved ``counts`` once, by ``counts`` less
    ``before_capture`` (what the run counts without the capture: its eager
    calls and the step's one run before the capture), and the card ran it
    at every replay. Checks that one graph was captured and that it holds
    what one eager step launches (``one_step``); returns counts + captured
    x (replays - 1) and the replays."""
    captures, replays = graphs
    check(captures == 1, f"{what}: {captures} graphs captured, not 1")
    captured = {k: counts[k] - before_capture[k] for k in counts}
    check(captured == one_step, f"{what}: one replay launches {captured}, "
                                f"one eager step {one_step}")
    print(f"  {what}: one graph captured, {replays} replays, each launching "
          f"{json.dumps({k: v for k, v in captured.items() if v})} (as an "
          "eager step)", flush=True)
    made = {k: counts[k] + captured[k] * (replays - 1) for k in counts}
    return made, replays


def expected_counts(prompt: int, max_length: int):
    steps = max_length - prompt
    return {**{k: 0 for k in counters()},
            "rms_norm_add": (2 * LAYERS + 1) * (1 + steps),
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


# the last serve() run of each (request, "eager" | "graph"): ms/step, tok/s,
# prefill tok/s, peak GiB (phase 17 prints its own beside phase 4's)
SERVED = {}


def serve(model, gen, name, request=None, expect=None):
    """Phase 4, request ``name`` (``request`` (batch, prompt, max_length),
    else ALL_REQUESTS's; ``expect`` the launches of a decode() run,
    decode_launches's): decode() with its step replayed as a CUDA
    graph (the main path) and uncaptured (``cuda_graph=False``), one after
    the other on the same prompt. Exact launches of both; graph tokens equal
    to eager tokens; the graph's logits against a second prefill. Returns
    the graph run's launches, sequences and logits."""
    from xhy_flash_attention_tpu_torch import decode
    b, prompt, max_length = request or ALL_REQUESTS[name]
    expect = expect or expected_counts
    steps = max_length - prompt
    vocab = model.config.vocab_size
    ids = torch.randint(0, vocab, (b, prompt), generator=gen, device="cuda")
    for graph in (False, True):  # warm-up: library handles and plans
        decode(model, ids, prompt + 2, cuda_graph=graph)
    runs = {}
    for graph in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        seq, scores = decode(model, ids, max_length, return_scores=True,
                             cuda_graph=graph)
        torch.cuda.synchronize()
        runs[graph] = dict(seq=seq, scores=scores,
                           total_s=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated())
        if graph:
            counts = decode_launches(f"request {name}, graph", prompt,
                                     max_length, expect)
        else:
            want = expect(prompt, max_length)
            check(read_counts() == want and read_graph_counts() == (0, 0),
                  f"request {name}, eager: launches {read_counts()} "
                  f"{read_graph_counts()} != {want}")
    eager, main = runs[False], runs[True]
    seq, scores = main["seq"], main["scores"]
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
    for graph, what in ((False, "eager"), (True, "graph")):
        r = runs[graph]
        decode_s = r["total_s"] - prefill_s
        SERVED[(name, what)] = dict(
            ms_per_step=decode_s / steps * 1e3, tok_s=b * steps / decode_s,
            prefill_tok_s=b * prompt / prefill_s, peak_gib=r["peak"] / 2**30)
        print(f"  request {name}, {what}: b{b} prompt {prompt} max_length "
              f"{max_length}: total {r['total_s']:.4f} s, prefill "
              f"{prefill_s:.4f} s ({b * prompt / prefill_s:.1f} tok/s), "
              f"decode {decode_s:.4f} s ({b * steps / decode_s:.1f} tok/s, "
              f"{decode_s / steps * 1e3:.3f} ms/step"
              + (", the capture included" if graph else "")
              + f"), max_memory_allocated {r['peak'] / 2**30:.3f} GiB",
              flush=True)
    same = bool(torch.equal(seq, eager["seq"]))
    gap = (scores - eager["scores"]).abs().max().item()
    print(f"  request {name}: graph tokens equal eager tokens: {same}; "
          f"logits max |graph - eager| {gap:.4g}", flush=True)
    check(same, f"request {name}: the graph's tokens differ from eager")
    compare_logits(f"request {name} graph decode logits vs a second prefill",
                   scores, logits[:, prompt - 1: max_length - 1],
                   seq[:, prompt:])
    print(f"  request {name} kernels: " + json.dumps(
        [{"tpu_kernel": TPU_OF[k], "cuda": k, "launches": v}
         for k, v in counts.items()]), flush=True)
    return counts, seq, scores


# ---------------------------------------------------------------- phase 5

_PKG = "xhy_flash_attention_tpu_torch.ops."


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain PyTorch versions,
    which run on the card's tensors as they are; restored on exit."""
    ln = importlib.import_module(_PKG + "layer_norm")
    fwd = importlib.import_module(_PKG + "flash_attention.fwd")
    fh = importlib.import_module(_PKG + "flash_attention.fused_heads")
    bwd = importlib.import_module(_PKG + "flash_attention.bwd")
    iface = importlib.import_module(_PKG + "flash_attention.interface")
    dk = importlib.import_module(_PKG + "flash_attention.decode_kernel")
    dec = importlib.import_module(_PKG + "decode")
    paged = importlib.import_module("xhy_flash_attention_tpu_torch.inference.paged")
    Dropout = importlib.import_module(_PKG + "flash_attention.common").Dropout

    def attention(q, k, v, *unused, sm_scale, causal, softcap, need_lse,
                  masks=None, dropout_p=0.0, dropout_seed=None, **flags):
        keep = masks.keep(q.shape[1], q.device) if masks is not None else None
        dropout = Dropout.make(dropout_p, dropout_seed)
        if keep is None or dropout is not None:  # the salts need all heads
            return fwd.attention_fwd_ref(q, k, v, sm_scale=sm_scale,
                                         causal=causal, softcap=softcap,
                                         need_lse=need_lse, mask=keep,
                                         dropout=dropout)
        out, lse = plain_fwd_groups(q, k, v, keep, sm_scale=sm_scale,
                                    causal=causal, softcap=softcap)
        return out, (lse if need_lse else None)

    def decode(q, k_cache, v_cache, lengths, *, softmax_scale, window_size,
               softcap, kv_batch_idx=None, leftpad_k=None):
        return dk.flash_decode_ref(q, k_cache, v_cache, lengths,
                                   softmax_scale, window_size, softcap,
                                   kv_batch_idx, leftpad_k)

    def paged_decode(q, cache, *, softmax_scale, window_size, softcap):
        return paged.paged_flash_decode_ref(q, cache, softmax_scale,
                                            window_size, softcap)

    def attention_bwd(q, k, v, out, lse, do, *unused, sm_scale, causal,
                      softcap, masks=None, dropout_p=0.0, dropout_seed=None,
                      **flags):
        keep = masks.keep(q.shape[1], q.device) if masks is not None else None
        dropout = Dropout.make(dropout_p, dropout_seed)
        if keep is None or dropout is not None:  # the salts need all heads
            return bwd.attention_bwd_ref(q, k, v, out, lse, do,
                                         sm_scale=sm_scale, causal=causal,
                                         softcap=softcap, mask=keep,
                                         dropout=dropout)
        return plain_bwd_groups(q, k, v, out, lse, do, keep,
                                sm_scale=sm_scale, causal=causal,
                                softcap=softcap)

    patches = [(ln, "ln_fwd", ln.ln_fwd_ref),
               (ln, "ln_bwd", ln.ln_bwd_ref),
               (iface, "flash_attention_fwd", attention),
               (iface, "flash_attention_bwd", attention_bwd),
               (fh, "fused_heads_fwd", fh.fused_heads_fwd_ref),
               (fh, "fused_heads_bwd", fh.fused_heads_bwd_ref),
               (dec, "flash_decode", decode),
               (paged, "paged_decode_chunked", paged_decode),
               (paged, "paged_decode_page", paged_decode)]
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
    b, prompt, max_length = ALL_REQUESTS[name]
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
    "flash_fwd_fp8": "ops/flash_attention/fwd.py:78 _fwd_kernel (fp8)",
    "flash_fwd_fp32": "ops/flash_attention/fwd.py:78 _fwd_kernel (fp32)",
    "flash_decode": "ops/flash_attention/decode_kernel.py:47 _decode_kernel",
    "flash_decode_splitkv": "inference/combine.py:75 _splitkv_kernel",
    "paged_decode (chunked)": "inference/paged.py:219 _paged_decode_chunked_kernel",
    "paged_decode (page)": "inference/paged.py:149 _paged_decode_kernel",
    "flash_bwd_prep": "ops/flash_attention/bwd.py:737 delta (XLA)",
    "flash_bwd_dkv": "ops/flash_attention/bwd.py:180 _bwd_dkv_kernel",
    "flash_bwd_dq": "ops/flash_attention/bwd.py:511 _bwd_dq_kernel",
    "flash_bwd_dkv_fp32": "ops/flash_attention/bwd.py:180 _bwd_dkv_kernel (fp32)",
    "flash_bwd_dq_fp32": "ops/flash_attention/bwd.py:511 _bwd_dq_kernel (fp32)",
    "flash_bwd_dbias": "ops/flash_attention/bwd.py:180 _bwd_dkv_kernel (dbias)",
    "flash_bwd_dbias_fp32":
        "ops/flash_attention/bwd.py:180 _bwd_dkv_kernel (dbias, fp32)",
    "fused_heads_bwd": "ops/flash_attention/fused_heads.py:105 _bwd_kernel",
    "ln_bwd": "ops/layer_norm.py:102 _ln_bwd_kernel",
    "reduced_scores": "ops/flash_attention/reduced_scores.py:34 _reduced_kernel",
}


# ---------------------------------------------------------------- phase 6

KERNEL_GROUPS = (  # device kernel name fragment -> group
    ("paged_decode_kernel", "paged_decode"),
    ("paged_prefill_kernel", "paged_decode"),
    ("flash_decode_kernel", "flash_decode"),
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_fwd_fp8_kernel", "flash_fwd"),
    ("flash_fwd_fp32_kernel", "flash_fwd"),
    ("flash_bwd_prep_kernel", "attention bwd"),
    ("flash_bwd_dkv_kernel", "attention bwd"),
    ("flash_bwd_dkv_fp32_kernel", "attention bwd"),
    ("flash_bwd_dbias_kernel", "attention bwd"),
    ("flash_bwd_dq_kernel", "attention bwd"),
    ("flash_bwd_dq_fp32_kernel", "attention bwd"),
    ("ln_fwd_kernel", "rms_norm_add"),
    ("ln_bwd_kernel", "norm bwd"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("nvjet", "matmul"), ("splitk", "matmul"),
)


def _group(kernel: str) -> str:
    low = kernel.lower()
    return next((g for frag, g in KERNEL_GROUPS if frag.lower() in low),
                "other")


def profile_steps(step, steps: int, label: dict):
    """``steps`` calls of ``step`` under torch.profiler (device activity
    only: tracing every host-side op would slow the host down and inflate
    the idle share): device time summed by kernel group per step, and the
    device's idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, calls, kernels = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        calls[g] = calls.get(g, 0) + e.count
        kernels.append((ms, e.key))
    busy = sum(groups.values())
    out = {**label, "steps": steps,
           "wall_ms_per_step_profiled": wall_ms / steps,
           "device_ms_per_step": {g: v / steps for g, v in sorted(
               groups.items(), key=lambda kv: -kv[1])},
           "kernels_per_step": {g: calls[g] / steps for g in sorted(calls)},
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "top_kernels_ms_per_step": [
               [k[:80], ms / steps] for ms, k in sorted(kernels)[::-1][:6]]}
    print(f"  decode step breakdown: {json.dumps(out)}", flush=True)
    if not busy:
        print("  the profiler saw no device time: breakdown not measured",
              flush=True)
    return out


class SpanTimer:
    """A step wrapped in CUDA events recorded before and after each call.
    Around a graph replay they time the graph on the device; around an
    eager step they also take in the device's waits for the host."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = self.step()
        e1.record()
        self.events.append((e0, e1))
        return out

    def ms_per_call(self) -> float:
        torch.cuda.synchronize()
        spans = [a.elapsed_time(b) for a, b in self.events]
        self.events = []
        return sum(spans) / max(len(spans), 1)


def time_steps(step, timer, n: int = 16):
    """Host ms per call of ``step`` over ``n`` calls ended by a synchronize,
    and the span ms per call of ``timer`` (a SpanTimer that ``step``
    calls)."""
    timer.ms_per_call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, timer.ms_per_call()


def compare_breakdowns(what, eager, graph, wall, span):
    """Print a graph step's device ms and kernels by group beside the eager
    step's, host ms per step, and the busy share that the graph's own
    events give (span / host ms)."""
    groups = sorted(set(eager["device_ms_per_step"])
                    | set(graph["device_ms_per_step"]))
    rows = {g: [round(eager["device_ms_per_step"].get(g, 0.0), 4),
                round(graph["device_ms_per_step"].get(g, 0.0), 4),
                eager["kernels_per_step"].get(g, 0),
                graph["kernels_per_step"].get(g, 0)] for g in groups}
    print(f"  {what}: ms/step (host clock, 16 steps) eager {wall[False]:.3f}, "
          f"graph {wall[True]:.3f}; CUDA-event span per step eager "
          f"{span[False]:.3f}, graph {span[True]:.3f} ms (graph busy share "
          f"{span[True] / wall[True]:.3f}); idle share under the profiler "
          f"eager {eager['device_idle_share']}, graph "
          f"{graph['device_idle_share']}; by group [eager ms, graph ms, "
          f"eager kernels, graph kernels] per step: {json.dumps(rows)}",
          flush=True)


def decode_breakdown(model, gen, name, steps: int = 8):
    """Where a decode step's time goes: request ``name``'s DecodeStep, the
    next token chosen on the device, uncaptured and as a CUDA graph: host
    ms per step and CUDA-event spans over 16 steps, then ``steps`` steps
    under torch.profiler, after one step (the capture)."""
    from xhy_flash_attention_tpu_torch.utils.generation import DecodeStep
    b, prompt, max_length = REQUESTS[name]
    ids = torch.randint(0, model.config.vocab_size, (b, prompt),
                        generator=gen, device="cuda")
    out, wall, span = {}, {}, {}
    for graph in (False, True):
        step = DecodeStep(model, b, max_length, cuda_graph=graph)
        with torch.inference_mode():
            logits, _ = model(ids, kv_caches=list(step.caches),
                              seqlen_offset=0)
        step.offset.fill_(prompt)
        step.tokens.copy_(logits[:, -1].argmax(-1, keepdim=True))
        timer = SpanTimer(step)

        def one():
            step.tokens.copy_(timer().argmax(-1, keepdim=True))

        one()
        wall[graph], span[graph] = time_steps(one, timer)
        out[graph] = profile_steps(one, steps, {
            "request": name, "path": "graph" if graph else "eager"})
        del step
    compare_breakdowns(f"request {name} decode step", out[False], out[True],
                       wall, span)
    return out


# --------------------------------------------------- phases 4b, 4c, 5, 6

ENGINE_RUN = dict(max_batch=8, page_size=512, max_pages_per_seq=8,
                  num_pages=65, prefill_chunk=512)
N_REQUESTS = 12
# An engine request's greedy token may differ from the argmax of a dense
# prefill over prompt + generated tokens only where that prefill puts it
# within a bound of its maximum: bf16 pages, NEAR_TIE (the pages hold the
# bf16 values a dense cache holds). INT8 pages add quantization error.
# Reading on an H100 (seed 0, all 32 layers, 12 requests): the largest gap
# of an INT8-page token, 0.3125 logit (bf16 pages: 0.1562). The bound is
# 1.5x that reading.
INT8_NEAR_TIE = 1.5 * 0.3125


def _model_dims(model):
    c = model.config
    return c.num_hidden_layers, c.kv_heads, c.dim_head


def _engine_requests(seed: int, vocab: int):
    """N_REQUESTS prompts of 64-2000 tokens and max_new_tokens of 16-64,
    drawn once from the seed."""
    import numpy as np
    from xhy_flash_attention_tpu_torch.inference import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 2001, N_REQUESTS)
    news = rng.integers(16, 65, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(lens, news))]


def _timed_engine(model, dtype, **kw):
    """An InferenceEngine whose prefill, chunk and decode steps are timed on
    the host clock around work that ends in a synchronize."""
    from xhy_flash_attention_tpu_torch.inference import InferenceEngine

    class TimedEngine(InferenceEngine):
        def _timed(self, key, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            self.times.setdefault(key, []).append(time.perf_counter() - t0)

        def _prefill_batch(self, reqs, cap):
            self._timed("prefill", super()._prefill_batch, reqs, cap)

        def _prefill_chunk_step(self):
            if self._prefilling:
                self._timed("chunk", super()._prefill_chunk_step)

        def _decode_step(self, active):
            # the first step captures the graph: timed on its own
            key = len(active) if self.stats["decode"] else "first"
            self._timed(key, super()._decode_step, active)

    layers, hk, d = _model_dims(model)
    eng = TimedEngine(model, num_layers=layers, num_kv_heads=hk, head_dim=d,
                      dtype=dtype, **kw)
    eng.times = {}
    return eng


def check_engine_tokens(model, what, reqs, bound):
    """Hold every request's generated tokens against one dense prefill over
    prompt + generated tokens: a token may differ from that prefill's
    argmax only within ``bound`` logit of its maximum."""
    worst, differ, total = 0.0, 0, 0
    with torch.inference_mode():
        for r in reqs:
            seq = torch.tensor(list(r.prompt) + r.output, device="cuda")
            logits, _ = model(seq[None])
            n = len(r.prompt)
            lg = logits[0, n - 1: n - 1 + len(r.output)].float()
            tok = torch.tensor(r.output, device="cuda")
            gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
            worst = max(worst, gap.max().item())
            differ += int((gap > 0).sum().item())
            total += len(r.output)
    print(f"  {what}: greedy tokens differ from the dense prefill's argmax "
          f"at {differ}/{total}, largest gap {worst:.4g} logit (bound "
          f"{bound:.4g})", flush=True)
    check(worst <= bound, f"{what}: a token differs by {worst} > {bound}")
    return dict(tokens_differ=differ, tokens=total, largest_gap=worst)


def serve_engine(model, dtype, seed, requests=None, run=None,
                 kernels=("flash_fwd (fused_heads)", "paged_decode (chunked)")):
    """Phase 4b: 12 greedy requests (``requests(seed, vocab)``,
    _engine_requests by default) through InferenceEngine (settings ``run``,
    ENGINE_RUN by default) at full width and depth, its decode step
    replayed as a CUDA graph (the main path) and uncaptured
    (``cuda_graph=False``): exact launches of both (``kernels``: the
    prefill's attention and the chunk and decode steps' paged entry),
    equal tokens, the graph's tokens against a dense prefill. Returns the
    graph run's launches and model calls."""
    layers = model.config.num_hidden_layers
    requests, run = requests or _engine_requests, run or ENGINE_RUN
    runs = {}
    for graph in (False, True):
        reqs = requests(seed, model.config.vocab_size)
        eng = _timed_engine(model, dtype, cuda_graph=graph, **run)
        for r in reqs:
            eng.add_request(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        runs[graph] = dict(reqs=reqs, eng=eng, results=results,
                           total_s=time.perf_counter() - t0,
                           counts=read_counts(), graphs=read_graph_counts(),
                           peak=torch.cuda.max_memory_allocated())
    st = runs[True]["eng"].stats
    check(runs[False]["eng"].stats == st,
          f"engine {SHORT[dtype]}: model calls {dict(st)} (graph) != "
          f"{dict(runs[False]['eng'].stats)} (eager)")

    def launches(decode_calls):
        calls = st["prefill"] + st["chunk"] + decode_calls
        return {**{k: 0 for k in counters()},
                "rms_norm_add": (2 * layers + 1) * calls,
                kernels[0]: layers * st["prefill"],
                kernels[1]: layers * (st["chunk"] + decode_calls)}

    want = launches(st["decode"])
    eager = runs[False]
    check(eager["counts"] == want and eager["graphs"] == (0, 0),
          f"engine {SHORT[dtype]}, eager: launches {eager['counts']} "
          f"{eager['graphs']} != {want}")
    counts, replays = replayed_launches(
        f"engine {SHORT[dtype]}, graph", runs[True]["counts"],
        runs[True]["graphs"], launches(1),
        {k: want[k] - launches(st["decode"] - 1)[k] for k in want})
    check(counts == want, f"engine {SHORT[dtype]}, graph: launches {counts} "
                          f"!= {want}")
    check(replays == st["decode"] - 1,
          f"engine: {replays} replays for {st['decode']} decode steps")
    reqs = runs[True]["reqs"]
    check(sorted(runs[True]["results"]) == list(range(len(reqs))) and all(
        len(runs[True]["results"][r.rid]) == r.max_new_tokens for r in reqs),
        "engine: a request did not finish with its tokens")
    gen_tokens = sum(r.max_new_tokens for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    print(f"  engine, {SHORT[dtype]} pages: {len(reqs)} requests, prompts "
          f"{[len(r.prompt) for r in reqs]}, new tokens "
          f"{[r.max_new_tokens for r in reqs]}; model calls {dict(st)}",
          flush=True)
    for graph, what in ((False, "eager"), (True, "graph")):
        r = runs[graph]
        times = r["eng"].times
        prefill_s = sum(times.get("prefill", [])) + sum(times.get("chunk", []))
        per_batch = {n: (1e3 * sum(t) / len(t), len(t))
                     for n, t in sorted((n, t) for n, t in times.items()
                                        if isinstance(n, int))}
        print(f"  engine {SHORT[dtype]}, {what}: total {r['total_s']:.4f} s, "
              f"generated {gen_tokens / r['total_s']:.1f} tok/s, prefill "
              f"{prompt_tokens / prefill_s:.1f} tok/s ({prefill_s:.4f} s in "
              f"prefill and chunk steps), first decode step "
              f"{1e3 * times['first'][0]:.3f} ms"
              + (" (the capture)" if graph else "")
              + ", decode ms/step by batch {batch: (ms, steps)} "
              + json.dumps({str(k): [round(v[0], 3), v[1]]
                            for k, v in per_batch.items()})
              + f", max_memory_allocated {r['peak'] / 2**30:.3f} GiB",
              flush=True)
    same = runs[True]["results"] == runs[False]["results"]
    print(f"  engine {SHORT[dtype]}: graph tokens equal eager tokens: {same}",
          flush=True)
    check(same, f"engine {SHORT[dtype]}: the graph's tokens differ from "
                "eager")
    bound_ = INT8_NEAR_TIE if dtype in QUANT else NEAR_TIE
    check_engine_tokens(model, f"engine {SHORT[dtype]} pages, graph", reqs,
                        bound_)
    print(f"  engine {SHORT[dtype]} kernels: " + json.dumps(
        [{"tpu_kernel": TPU_OF[k], "cuda": k, "launches": v}
         for k, v in counts.items() if v]), flush=True)
    return counts, st


def _kvcache_inputs(gen, b, hk, S, d, h):
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, 1, hk, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, 1, hk, d, generator=gen, device="cuda").bfloat16()
    return q, k, v


def kvcache_api(gen):
    """Phase 4c: flash_attn_with_kvcache, the decode entry a user calls per
    layer, at Llama-3-8B width for all 32 layers of request A's last step:
    append + rotary + split-KV (num_splits=0) over bf16 (b, S, hk, d) caches
    and int8 QuantizedKV caches, an e4m3 QuantizedKV cache through
    flash_decode, and a PagedKVCache of one page per sequence (the page
    entry). Layer 0 of each is held against the same call on the CPU (the
    plain versions): two bf16 units of the largest output (rotary's cos/sin
    round differently on the two devices)."""
    from xhy_flash_attention_tpu_torch import flash_attn_with_kvcache
    from xhy_flash_attention_tpu_torch.inference import PagedKVCache
    from xhy_flash_attention_tpu_torch.layers.rotary import RotaryEmbedding
    from xhy_flash_attention_tpu_torch.ops.quant import quantize_kv
    c = LLAMA3_8B
    b, _, S = REQUESTS["A"]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    cos, sin = RotaryEmbedding(d, base=c["rope_theta"]).cos_sin(
        S, torch.bfloat16, device="cuda")
    seqlens = torch.full((b,), S - 1, dtype=torch.int32, device="cuda")

    def dense(kind):
        x = [torch.randn(b, S, hk, d, generator=gen, device="cuda")
             for _ in range(2)]
        if kind == "bf16":
            return tuple(t.bfloat16() for t in x)
        return tuple(quantize_kv(t.transpose(1, 2).contiguous(),
                                 {"int8": torch.int8,
                                  "e4m3": torch.float8_e4m3fn}[kind])
                     for t in x)

    def paged():
        kv = torch.randn(b + 1, hk, 2, 4096, d, generator=gen,
                         device="cuda").bfloat16()
        table = torch.arange(b, dtype=torch.int32, device="cuda")[:, None]
        return PagedKVCache(kv, table, seqlens.clone())

    def to_cpu(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.cpu()
        if isinstance(x, tuple):
            return tuple(to_cpu(t) for t in x)
        return type(x)(**{f: to_cpu(getattr(x, f)) for f in
                          x.__dataclass_fields__})

    cases = [("split-KV, bf16 (b, S, hk, d) caches", dense, "bf16", 0),
             ("split-KV, int8 QuantizedKV", dense, "int8", 0),
             ("flash_decode, e4m3 QuantizedKV", dense, "e4m3", 1),
             ("paged, one page of 4096 per sequence", None, "paged", 1)]
    counts = {}
    for what, make, kind, splits in cases:
        reset_counts()
        for layer in range(LAYERS):
            cache = paged() if kind == "paged" else make(kind)
            q, k, v = _kvcache_inputs(gen, b, hk, S, d, h)
            args = ((cache, None) if kind == "paged" else cache)
            kw = dict(rotary_cos=cos, rotary_sin=sin, num_splits=splits)
            if kind != "paged":
                kw["cache_seqlens"] = seqlens
            if layer == 0:
                cpu_args = to_cpu(args)
                want = flash_attn_with_kvcache(
                    q.cpu(), *cpu_args, k.cpu(), v.cpu(),
                    **{n: to_cpu(t) if isinstance(t, torch.Tensor) else t
                       for n, t in kw.items()})[0]
            out = flash_attn_with_kvcache(q, *args, k, v, **kw)[0]
            if layer == 0:
                torch.cuda.synchronize()
                err = max_err(out.cpu(), want)
                tol = 2 * BF16_ULP * want.float().abs().max().item() + 1e-3
                print(f"  flash_attn_with_kvcache, {what}: layer 0 against "
                      f"the CPU: max |diff| {err:.4g} (tol {tol:.4g})",
                      flush=True)
                check(err <= tol, f"flash_attn_with_kvcache {what}: {err}")
            del cache
        torch.cuda.synchronize()
        counts[kind] = read_counts()
    return counts


def quantized_decode(model, name, seq, scores, dtype):
    """Phase 4c: request ``name`` through decode(cache_dtype=int8 | e4m3),
    teacher-forced on the bf16 run's tokens, against that run's logits."""
    from xhy_flash_attention_tpu_torch import decode
    b, prompt, max_length = ALL_REQUESTS[name]
    t0 = time.perf_counter()
    _, got = decode(model, seq[:, :prompt], max_length, teacher_outputs=seq,
                    return_scores=True, cache_dtype=dtype)
    torch.cuda.synchronize()
    diff = (got - scores).abs()
    dmax = diff.max().item()
    rms = diff.square().mean().sqrt().item()
    tol, rms_tol = QUANT_TOL[dtype]
    print(f"  decode(cache_dtype={SHORT[dtype]}), request {name}: "
          f"{time.perf_counter() - t0:.4f} s; logits against the bf16 cache: "
          f"max |difference| {dmax:.4g}, rms {rms:.4g} (bounds {tol:.4g}, "
          f"{rms_tol:.4g})", flush=True)
    check(bool(torch.isfinite(got).all()), "non-finite quantized logits")
    check(dmax <= tol and rms <= rms_tol,
          f"decode(cache_dtype={SHORT[dtype]}) logits off by {dmax} (rms {rms})")


# Quantized dense caches against the bf16 cache: the logits of request A's
# 32 teacher-forced decode steps. Readings on an H100 (seed 0, all 32
# layers): int8 largest difference 0.6211 logit, rms 0.1074; e4m3 (three
# mantissa bits) 2.375, rms 0.3795. Bounds: 1.5x the readings.
QUANT_TOL = {torch.int8: (1.5 * 0.6211, 1.5 * 0.1074),
             torch.float8_e4m3fn: (1.5 * 2.375, 1.5 * 0.3795)}


def engine_vs_plain(model, dtype, seed):
    """Phase 5 (engine): eight requests admitted into an engine, then one
    decode step at full depth through the kernels and through the plain
    versions on clones of the same paged caches. Returns the engine, its
    slots still decoding, for phase 6."""
    import numpy as np
    from xhy_flash_attention_tpu_torch.inference import Request
    layers = model.config.num_hidden_layers
    rng = np.random.default_rng(seed + 1)
    eng = _timed_engine(model, dtype, **{**ENGINE_RUN, "prefill_chunk": None})
    for i, n in enumerate(rng.integers(64, 2001, ENGINE_RUN["max_batch"])):
        eng.add_request(Request(
            rid=i, prompt=rng.integers(0, model.config.vocab_size, n).astype(
                np.int32), max_new_tokens=1000))
    eng._admit()
    for r in eng.slots:  # pages for the next token
        while len(r.pages) < (len(r.prompt) + 1) // eng.page_size + 1:
            eng._alloc_page(r)
    eng._sync_caches()
    tokens = torch.from_numpy(eng._last_tokens[:, None]).cuda()
    kern = list(eng.caches)
    plain = [c.clone() for c in eng.caches]
    lengths = eng.caches[0].lengths
    with torch.inference_mode():
        reset_counts()
        lk, kern = model(tokens, kv_caches=kern, seqlen_offset=lengths)
        with plain_versions():
            lp, plain = model(tokens, kv_caches=plain, seqlen_offset=lengths)
    want = {**{k: 0 for k in counters()}, "paged_decode (chunked)": layers,
            "rms_norm_add": 2 * layers + 1}
    check(read_counts() == want,
          f"engine decode steps launched {read_counts()}, not {want}")
    compare_logits(f"engine decode step, {SHORT[dtype]} pages, kernels vs "
                   "plain", lk, lp)
    # the step appended one row per sequence and layer: everything else in
    # the pages and scales is bit-equal
    table, lens = eng._table, eng._lengths
    rows = [(int(table[i, lens[i] // eng.page_size]), int(lens[i] %
             eng.page_size)) for i in range(len(lens))]
    row_err = 0.0
    for a, c in zip(kern, plain):
        pa, pc = a.kv_pages.clone(), c.kv_pages.clone()
        for i, (page, off) in enumerate(rows):
            x, y = pa[page, :, :, off].float(), pc[page, :, :, off].float()
            if a.kv_scales is not None:
                x = x * a.kv_scales[i, :, :, lens[i], None]
                y = y * c.kv_scales[i, :, :, lens[i], None]
            row_err = max(row_err, max_err(x, y))
            pa[page, :, :, off] = 0
            pc[page, :, :, off] = 0
        check(torch.equal(pa.view(torch.uint8), pc.view(torch.uint8)),
              "the kernel and plain steps wrote different pages outside the "
              "appended rows")
        if a.kv_scales is not None:
            sa, sc = a.kv_scales.clone(), c.kv_scales.clone()
            for i in range(len(lens)):
                sa[i, :, :, lens[i]] = 0
                sc[i, :, :, lens[i]] = 0
            check(torch.equal(sa, sc), "scales differ outside the new rows")
    print(f"  engine step, {SHORT[dtype]} pages: pages and scales bit-equal "
          f"outside the appended rows; appended rows (the new K/V, after 32 "
          f"layers of kernel vs plain rounding) max |diff| {row_err:.4g}",
          flush=True)
    for r in eng.slots:
        eng._lengths[r.slot] += 1
        r.output.append(int(lk[r.slot, 0].argmax()))
        eng._last_tokens[r.slot] = r.output[-1]
    return eng


# Reading of the engine step's paged_decode group with the earlier paged
# kernel, on an H100 at 700 W (PERF.md section 5), printed beside this run's
PAGED_EARLIER_STEP_MS = 7.98


def engine_breakdown(eng, steps: int = 6):
    """Phase 6 (engine): decode steps of eight sequences over bf16 pages,
    uncaptured and then as a CUDA graph: host ms per step and CUDA-event
    spans of the step over 16 steps, then ``steps`` steps under
    torch.profiler."""
    active = [r for r in eng.slots if r is not None]
    out, wall, span = {}, {}, {}
    for graph in (False, True):
        eng.cuda_graph = graph
        eng._steps.clear()
        timer = SpanTimer(eng._step(1))
        eng._steps[1] = timer
        eng._decode_step(active)  # the capture
        wall[graph], span[graph] = time_steps(
            lambda: eng._decode_step(active), timer)
        out[graph] = profile_steps(
            lambda: eng._decode_step(active), steps,
            {"engine": f"{len(active)} sequences, lengths "
                       f"{eng._lengths.tolist()}",
             "path": "graph" if graph else "eager"})
        o = out[graph]
        print(f"  engine step, {o['path']}: paged_decode "
              f"{o['device_ms_per_step'].get('paged_decode', 0.0):.4f} ms of "
              f"{o['wall_ms_per_step_profiled']:.4f} ms profiled, idle share "
              f"{o['device_idle_share']} (the "
              f"earlier kernel: paged_decode {PAGED_EARLIER_STEP_MS} ms of "
              "87.0)", flush=True)
    compare_breakdowns("engine decode step, batch 8", out[False], out[True],
                       wall, span)
    return out


def chunk_breakdown(model, seed, steps: int = 2):
    """Phase 6 (engine): chunked-prefill steps, which run eagerly: eight
    prompts of 1600-2000 tokens in chunks of 512 (b8, sq 512 through the
    paged prefill regime) under torch.profiler, after one unprofiled
    chunk."""
    import numpy as np
    from xhy_flash_attention_tpu_torch.inference import Request
    rng = np.random.default_rng(seed + 2)
    eng = _timed_engine(model, torch.bfloat16, **ENGINE_RUN)
    for i, n in enumerate(rng.integers(1600, 2001, ENGINE_RUN["max_batch"])):
        eng.add_request(Request(
            rid=i, prompt=rng.integers(0, model.config.vocab_size, n).astype(
                np.int32), max_new_tokens=1))
    eng._admit()
    eng._prefill_chunk_step()
    return profile_steps(eng._prefill_chunk_step, steps, {
        "engine": "chunked-prefill step, 8 prompts in chunks of 512",
        "path": "eager"})


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


# ------------------------------------------ phase 3: the backward kernels

T_LONG = dict(b=16, h=16, hk=16, s=2048, d=64)   # gpt3m-flash.yaml
T_GQA = dict(b=2, h=32, hk=8, s=2048, d=128)     # Llama-3-8B width
T_PACKED = dict(b=32, h=16, hk=16, s=1024, d=64)  # gpt2m-flash.yaml


def _sdpa_bwd_ms(q, k, v, do):
    """SDPA's backward alone: fwd + bwd minus fwd (library yardstick)."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    gqa = q.shape[1] != k.shape[1]

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              enable_gqa=gqa)
    both = time_ms([lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)],
                   iters=10)
    with torch.no_grad():
        only = time_ms([fwd], iters=10)
    return both - only


def _attn_grad_contract(grads, q, k, v, do):
    """The repository's contract on gradients, on the first batch element:
    each kernel gradient's error against the fp32 `attention_ref` gradient
    is at most twice the bf16 reorder-ops baseline's. Returns the worst
    (error, baseline error) pair."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_ref

    def ref_grads(upcast, reorder):
        ins = [t[:1].detach().clone().requires_grad_() for t in (q, k, v)]
        out, _ = attention_ref(*ins, causal=True, upcast=upcast,
                               reorder_ops=reorder)
        return torch.autograd.grad(out, ins, do[:1])
    want, low = ref_grads(True, False), ref_grads(False, True)
    worst = (0.0, 0.0)
    for g, w, lo in zip(grads, want, low):
        e, e_lp = max_err(g[:1], w), max_err(lo, w)
        check(e <= 2 * e_lp + 1e-3,
              f"attention gradient err vs fp32 ref {e} > 2 x bf16 baseline "
              f"{e_lp}")
        worst = max(worst, (e, e_lp))
    return worst


def _bwd_inputs(gen, shape):
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    # (b, s, h, d) memory as the model's projections give it
    q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, s, hk, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    return (q, k, v, do), (qt, kt, vt, dot, out, lse), kw


def check_bwd_prep(qt, out, dot, sm_scale, label):
    """The backward's pre-pass (delta = rowsum(dO O) and q_s) at ``label``'s
    shape against its plain version: q_s bit for bit, delta within 1e-5 of
    its largest entry (fp32 sums in another order). Bound: its bytes (q, dO
    and O read, q_s and delta written). No single PyTorch call computes
    the pair: library_ms is null."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, s, d = qt.shape
    qs, delta = bwd.flash_bwd_prep(qt, out, dot, sm_scale=sm_scale)
    want_qs, want = bwd.bwd_prep_ref(qt, out, dot, sm_scale=sm_scale)
    torch.cuda.synchronize()
    err, tol = max_err(delta, want), 1e-5 * want.abs().max().item()
    check(torch.equal(qs, want_qs) and err <= tol,
          f"flash_bwd_prep ({label}): q_s differs or delta err {err} > {tol}")
    del want_qs, want
    nbytes = 2.0 * b * h * s * d * 4 + 4.0 * b * h * s
    bms, by = bound(3.0 * b * h * s * d, PEAK_FP32_FLOPS, nbytes)
    row = dict(
        name=f"flash_bwd_prep ({label})", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/bwd.py:737",
        kernel="flash_bwd_prep", max_abs_err=err,
        ms=time_ms([lambda: bwd.flash_bwd_prep(qt, out, dot,
                                               sm_scale=sm_scale)]),
        plain_ms=time_ms([lambda: bwd.bwd_prep_ref(qt, out, dot,
                                                   sm_scale=sm_scale)],
                         iters=5, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    report(row, f"q_s bitwise equal; delta tol {tol:.3g} = 1e-5 of "
                f"max|delta|; b{b} h{h} s{s} d{d}, bytes {nbytes:.4g} (q, "
                "dO, O read, q_s, delta written); no single library call")
    print(f"  delta pre-pass ({label}): {row['ms']:.4f} ms against its byte "
          f"bound {bms:.4f} ms ({nbytes / row['ms'] / 1e9:.1f} GB/s, share "
          f"{bms / row['ms']:.3f})", flush=True)
    return row, qs, delta


def _bitwise_three_passes(run, what):
    first = run()
    for _ in range(2):
        check(all(torch.equal(a, c) for a, c in zip(first, run())),
              f"{what} is not bitwise deterministic")
    print(f"  {what}: three passes bitwise equal (dq, dk, dv)", flush=True)


def check_flash_bwd(gen, shape, label):
    """Rows for the pre-pass, the dK/dV kernel (#2) and the dQ kernel (#3)
    at ``shape``, a line for the whole backward (pre-pass and both kernels)
    against SDPA's backward and the 5-product bound, and the bitwise
    determinism of three backward passes."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    (q, k, v, do), (qt, kt, vt, dot, out, lse), kw = _bwd_inputs(gen, shape)
    grads = bwd.flash_attention_bwd(qt, kt, vt, out, lse, dot, **kw)
    want = bwd.attention_bwd_ref(qt, kt, vt, out, lse, dot, **kw)
    torch.cuda.synchronize()
    err_dq = max_err(grads[0], want[0])
    err_dkv = max(max_err(grads[1], want[1]), max_err(grads[2], want[2]))
    tol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(max(err_dq, err_dkv) <= tol,
          f"flash_bwd {label}: err vs plain {err_dq}, {err_dkv} > {tol}")
    del want
    e, e_lp = _attn_grad_contract([g.transpose(1, 2) for g in grads],
                                  q, k, v, do)
    _bitwise_three_passes(lambda: bwd.flash_attention_bwd(
        qt, kt, vt, out, lse, dot, **kw), f"attention backward at {label}")
    prep, qs, delta = check_bwd_prep(qt, out, dot, kw["sm_scale"], label)
    dq, dk, dv = (torch.empty_like(t) for t in grads)
    del grads
    args = (qs, kt, vt, dot, lse, delta, dq, dk, dv)
    pair = 2.0 * b * h * s * s * d / 2  # one causal s x s x d product
    io = 2.0 * b * s * d * (2 * h + 2 * hk)  # q, do, k, v (bf16)
    stats = 2 * 4.0 * b * h * s  # lse, delta (fp32)
    plain_ms = time_ms([lambda: bwd.attention_bwd_ref(
        qt, kt, vt, out, lse, dot, **kw)], iters=3, warmup=1)
    library = _sdpa_bwd_ms(qt, kt, vt, dot)
    rows = [prep]
    for name, fn, n_mm, out_bytes, err in (
            ("flash_bwd_dkv", bwd.flash_bwd_dkv, 4, 2 * 2.0 * b * s * hk * d,
             err_dkv),
            ("flash_bwd_dq", bwd.flash_bwd_dq, 3, 2.0 * b * s * h * d,
             err_dq)):
        bms, by = bound(n_mm * pair, PEAK_BF16_FLOPS, io + stats + out_bytes)
        row = dict(
            name=f"{name} ({label})", route="cuda",
            source="xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu",
            replaces=("xhy_flash_attention_tpu/ops/flash_attention/bwd.py:180"
                      if name == "flash_bwd_dkv" else
                      "xhy_flash_attention_tpu/ops/flash_attention/bwd.py:511"),
            kernel=name, max_abs_err=err,
            ms=time_ms([lambda fn=fn: fn(*args, **kw)], iters=10),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library)
        report(row, f"tol {tol:.3g} = 4 bf16 ulp of max|grad| vs the plain "
                    f"backward; vs fp32 attention_ref grads {e:.3g} <= 2 x "
                    f"bf16 baseline {e_lp:.3g}; b{b} h{h} hk{hk} s{s} d{d} "
                    f"causal, {n_mm} products, flops {n_mm * pair:.4g} "
                    f"({n_mm * pair / row['ms'] / 1e9:.1f} TFLOP/s); "
                    "plain_ms and library_ms are of the whole backward "
                    "(library: SDPA fwd + bwd minus fwd)")
        rows.append(row)
    whole_ms = time_ms([lambda: bwd.flash_attention_bwd(
        qt, kt, vt, out, lse, dot, **kw)], iters=10)
    bms, by = bound(5 * pair, PEAK_BF16_FLOPS,
                    io + stats + 2.0 * b * s * d * (h + 2 * hk))
    summed = rows[1]["ms"] + rows[2]["ms"]
    print(f"  attention backward ({label}): pre-pass {prep['ms']:.4f} + "
          f"dK/dV {rows[1]['ms']:.4f} + dQ {rows[2]['ms']:.4f} = "
          f"{prep['ms'] + summed:.4f} ms; flash_attention_bwd whole "
          f"{whole_ms:.4f} ms against SDPA's backward {library:.4f} ms "
          f"(x{whole_ms / library:.3f}) and the 5-product bound of the "
          f"function {bms:.4f} ms by {by} (share {bms / whole_ms:.3f})",
          flush=True)
    return rows


def check_fused_heads_bwd(gen):
    """The packed entry (#6) at T-packed's shape: one dqkv written through
    strides, against its plain version and the contract, three passes
    bitwise equal."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as fh
    c = T_PACKED
    b, h, hk, s, d = (c[k] for k in ("b", "h", "hk", "s", "d"))
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                      device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    q, k, v = fh._split(qkv, h, hk, d)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
    dqkv = torch.empty_like(qkv)
    dst = dict(zip(("dq", "dk", "dv"), fh._split(dqkv, h, hk, d)))
    grads = fh.fused_heads_bwd(q, k, v, out, lse, do, **kw, **dst)
    want = fh.fused_heads_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    err = max(max_err(g, w) for g, w in zip(grads, want))
    tol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(err <= tol, f"fused_heads_bwd err {err} > {tol}")
    del want
    e, e_lp = _attn_grad_contract(grads, q, k, v, do)
    _bitwise_three_passes(lambda: [t.clone() for t in fh.fused_heads_bwd(
        q, k, v, out, lse, do, **kw, **dst)], "packed backward at T-packed")
    pair = 2.0 * b * h * s * s * d / 2
    nbytes = (2.0 * b * s * d * (2 * h + 2 * hk) + 2 * 4.0 * b * h * s
              + 2.0 * b * s * d * (h + 2 * hk))
    bms, by = bound(5 * pair, PEAK_BF16_FLOPS, nbytes)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    row = dict(
        name="fused_heads_bwd (T-packed)", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:105",
        kernel="fused_heads_bwd", max_abs_err=err,
        ms=time_ms([lambda: fh.fused_heads_bwd(q, k, v, out, lse, do, **kw,
                                               **dst)], iters=10),
        plain_ms=time_ms([lambda: fh.fused_heads_bwd_ref(
            q, k, v, out, lse, do, **kw)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=_sdpa_bwd_ms(qt, kt, vt, dot))
    report(row, f"tol {tol:.3g} = 4 bf16 ulp of max|grad|; vs fp32 "
                f"attention_ref grads {e:.3g} <= 2 x bf16 baseline "
                f"{e_lp:.3g}; packed dqkv b{b} s{s} h{h} hk{hk} d{d} causal, "
                f"5-product bound (flops {5 * pair:.4g}); ms includes the "
                "pre-pass and both kernels; library: SDPA fwd + bwd minus "
                "fwd")
    print(f"  attention backward (T-packed, packed dqkv): whole "
          f"{row['ms']:.4f} ms against SDPA's backward "
          f"{row['library_ms']:.4f} ms (x{row['ms'] / row['library_ms']:.3f})",
          flush=True)
    return row


def check_ln_bwd(gen, rows, hidden, rms, label):
    """The norm backward (#8), prenorm with an fp32 residual, against its
    plain version; library: autograd of residual add + F.layer_norm /
    F.rms_norm, backward alone."""
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    x0 = torch.randn(rows, hidden, generator=gen, device="cuda").bfloat16()
    res = 4 * torch.randn(rows, hidden, generator=gen, device="cuda")
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    bias = None if rms else 0.1 * torch.randn(hidden, generator=gen,
                                              device="cuda")
    eps = 1e-5
    _, resout, mu, rstd = ln.ln_fwd(x0, res, w, bias, eps, rms,
                                    torch.float32, True, True)
    dout = torch.randn(rows, hidden, generator=gen, device="cuda").bfloat16()
    dres_in = torch.randn(rows, hidden, generator=gen, device="cuda")
    kw = dict(is_rms=rms, has_bias=bias is not None, x0_dtype=torch.bfloat16,
              res_dtype=torch.float32)
    args = (dout, dres_in, resout, mu, rstd, w)
    got = ln.ln_bwd(*args, **kw)
    want = ln.ln_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    tol = BF16_ULP * want[0].float().abs().max().item() + 1e-6
    check(max_err(got[0], want[0]) <= tol, f"ln_bwd dx0 err > {tol}")
    check(max_err(got[1], want[1]) <= 1e-5 * want[1].abs().max().item(),
          "ln_bwd dresidual err")
    err_g = max(max_err(g, wt) / wt.abs().max().item()
                for g, wt in zip(got[2:], want[2:]) if g is not None)
    check(err_g <= 1e-4, f"ln_bwd dgamma/dbeta relative err {err_g}")
    # dout bf16, resout, dres_in fp32, mu/rstd in; dx0 bf16, dres fp32,
    # dgamma (dbeta) fp32 out
    nbytes = rows * hidden * (2 + 4 + 4 + 2 + 4) + rows * 8 \
        + hidden * 4 * (3 if bias is not None else 2)
    flops = 10.0 * rows * hidden
    bms, by = bound(flops, PEAK_FP32_FLOPS, nbytes)
    leaves = [t.detach().requires_grad_() for t in (x0, res, w)] + (
        [bias.detach().requires_grad_()] if bias is not None else [])

    def lib_fwd():
        xs = leaves[0].float() + leaves[1]
        y = (F.rms_norm(xs, (hidden,), leaves[2], eps) if rms else
             F.layer_norm(xs, (hidden,), leaves[2], leaves[3], eps))
        return y.bfloat16(), xs
    both = time_ms([lambda: torch.autograd.grad(lib_fwd(), leaves,
                                                (dout, dres_in))])
    with torch.no_grad():
        only = time_ms([lib_fwd])
    row = dict(
        name=f"ln_bwd ({label})", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/rms_norm_add.cu",
        replaces="xhy_flash_attention_tpu/ops/layer_norm.py:102",
        kernel="ln_bwd", max_abs_err=err,
        ms=time_ms([lambda: ln.ln_bwd(*args, **kw)]),
        plain_ms=time_ms([lambda: ln.ln_bwd_ref(*args, **kw)]),
        bound_ms=bms, bound_by=by, library_ms=both - only)
    report(row, f"dx0 tol {tol:.3g} = 1 bf16 ulp of max|dx0|; dresidual "
                f"1e-5 relative; dgamma/dbeta relative err {err_g:.3g} <= "
                f"1e-4 (fp32 partials summed in another order); {rows} rows "
                f"x {hidden}, prenorm, fp32 residual, bytes {nbytes:.4g}; "
                "library: autograd of add + F."
                + ("rms_norm" if rms else "layer_norm") + ", backward alone")
    return row


# ------------------------- phase 3: the sparse-mask kernels, and phase 11

FM_DOC = dict(b=16, h=16, hk=16, s=2048, d=64)  # gpt3m-flash.yaml attention
FM_SWG = dict(b=1, h=32, hk=8, s=8192, d=128)   # Llama-3-8B width
FM_FULL = dict(b=2, h=16, hk=16, s=2048, d=64)
FM_FULL_HEADS = 4                               # mask heads of FM-full
BS = dict(b=16, h=16, hk=16, s=2048, d=64)
BS_BLOCK = 256                                  # block-sparse granularity
SWG_WINDOW, SWG_GLOBAL = 1024, 64
DOC_LENGTHS = (128, 1024)                       # FM-doc document lengths
SW = dict(b=1, h=32, hk=8, s=8192, d=128)       # Mistral-7B width prefill
SW_WINDOW = (4095, 0)                           # sliding_window 4096
VL_DOC = dict(b=1, h=16, hk=16, s=32768, d=64)  # T-long's attention, packed
VL_DOC_LENGTHS = (128, 2048)
VL_GQA = dict(b=1, h=32, hk=8, s=16384, d=128)  # Llama-3-8B width, packed
VL_GQA_LENGTHS = (512, 4096)
# the plain versions run a group of kv heads at a time, so that one fp32
# score tensor stays under this size (8.6 GB at FM-swg's whole width)
PLAIN_CHUNK_BYTES = 1.2e9


def _dims(shape):
    return tuple(shape[k] for k in ("b", "h", "hk", "s", "d"))


def _sparse_inputs(gen, shape, dtype=torch.bfloat16):
    """q, do (b, h, s, d) and k, v (b, hk, s, d): bf16 (or ``dtype``),
    contiguous."""
    b, h, hk, s, d = _dims(shape)
    q, do = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, do


def doc_rows(gen, b, s):
    """(b, s) document ids of rows packed with documents whose lengths are
    drawn uniformly in DOC_LENGTHS, the last one cut at s."""
    lo, hi = DOC_LENGTHS
    lens = torch.randint(lo, hi + 1, (b, s // lo + 1), generator=gen,
                         device="cuda")
    docs = torch.arange(lens.shape[1], device="cuda")
    return torch.stack([torch.repeat_interleave(docs, n)[:s] for n in lens])


def doc_indices(gen, b, s):
    """FM-doc: causal_document_mask of doc_rows' documents; (b, 1, s, 1)."""
    from xhy_flash_attention_tpu_torch import causal_document_mask
    return causal_document_mask(doc_rows(gen, b, s))


def random_bands(gen, nv, b, hm, s):
    """FM-full: random non-causal bands drawn as tests/test_flashmask.py
    draws them; (b, hm, s, NV)."""
    def ints(lo, hi):  # uniform in [lo, hi); hi an int or a tensor
        u = torch.rand(b, hm, s, generator=gen, device="cuda")
        return (lo + u * (hi - lo)).long()
    lts = ints(0, s + 1)
    if nv == 2:  # [LTStart, UTEnd], UTEnd <= LTStart
        vecs = [lts, ints(0, lts + 1)]
    else:
        uts = ints(0, s + 1)
        vecs = [lts, torch.clamp(lts + ints(0, s // 2), max=s), uts,
                torch.clamp(uts + ints(0, s // 2), max=s)]
    return torch.stack(vecs, -1).to(torch.int32)


def bigbird_mask(gen, b, nb):
    """BS: a local band of +-1 block, block column 0 global and one random
    block per block row, per batch element; (b, 1, nb, nb) int32."""
    i = torch.arange(nb, device="cuda")
    m = ((i[:, None] - i[None, :]).abs() <= 1) | (i[None, :] == 0)
    m = m[None].repeat(b, 1, 1)
    pick = torch.randint(0, nb, (b, nb, 1), generator=gen, device="cuda")
    m.scatter_(2, pick, True)
    return m[:, None].to(torch.int32)


def _flags(indices=None, causal=False, block_mask=None):
    """The kernel flags of a FlashMask index tensor or a block mask."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import \
        fm_mode_for
    if indices is not None:
        return dict(flashmask_vecs=indices.movedim(-1, 2).to(torch.int32),
                    flashmask_mode=fm_mode_for(causal, indices.shape[-1]))
    return dict(block_mask=(block_mask, BS_BLOCK, BS_BLOCK))


def _keep(flags, causal, h, sq, sk):
    """The dense keep mask of ``flags`` (b|1, hm|1, sq, sk), the causal
    part included (for the visible-pair count and SDPA's mask)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import common
    return _causal_part(common.dense_keep_mask(sq, sk, h, **flags), causal,
                        sq, sk)


def _causal_part(keep, causal, sq, sk):
    """``keep`` with the plain causal flag's part ANDed in."""
    if causal:
        rows = torch.arange(sq, device="cuda")[:, None]
        cols = torch.arange(sk, device="cuda")[None, :]
        keep = keep & (cols <= rows + (sk - sq))
    return keep


def visible_pairs(keep, b, h):
    """(row, key) pairs attended over all batch elements and heads."""
    return (float(keep.sum(dtype=torch.int64).item()) * (b / keep.shape[0])
            * (h / keep.shape[1]))


def _sdpa_masked_ms(q, k, v, do, keep):
    """SDPA with the dense boolean mask: (forward ms, backward ms as fwd +
    bwd minus fwd), the library yardstick of the sparse rows. Under GQA k
    and v are repeated to every query head first (outside the timing): SDPA
    takes a mask with GQA only on its math path."""
    g = q.shape[1] // k.shape[1]
    qg, kg, vg = (t.detach().repeat_interleave(n, 1).requires_grad_()
                  for t, n in ((q, 1), (k, g), (v, g)))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
    with torch.no_grad():
        only = time_ms([fwd], iters=10)
    both = time_ms([lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)],
                   iters=10)
    return only, both - only


def plain_bwd_groups(q, k, v, out, lse, do, keep, **kw):
    """The plain backward with the dense keep mask, a group of kv heads at
    a time (PLAIN_CHUNK_BYTES): dq, dk, dv."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, common
    b, h, sq, _ = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    keep = common.expand_heads(keep, h)
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    parts = []
    for j in range(0, hk, step):
        hs, ks = slice(j * g, (j + step) * g), slice(j, j + step)
        parts.append(bwd.attention_bwd_ref(
            q[:, hs], k[:, ks], v[:, ks], out[:, hs], lse[:, hs], do[:, hs],
            mask=keep if keep.shape[1] == 1 else keep[:, hs], **kw))
    return [torch.cat(t, 1) for t in zip(*parts)]


def plain_fwd_groups(q, k, v, keep, **kw):
    """The plain forward with the dense keep mask, a group of kv heads at a
    time (PLAIN_CHUNK_BYTES): out, lse."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import common, fwd
    b, h, sq, _ = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    keep = common.expand_heads(keep, h)
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    parts = []
    for j in range(0, hk, step):
        hs, ks = slice(j * g, (j + step) * g), slice(j, j + step)
        parts.append(fwd.attention_fwd_ref(
            q[:, hs], k[:, ks], v[:, ks], need_lse=True,
            mask=keep if keep.shape[1] == 1 else keep[:, hs], **kw))
    return [torch.cat(t, 1) for t in zip(*parts)]


def exp_floor_ms(pairs: float) -> float:
    """The least time the card's exponent units take for one exp per pair:
    16 ex2 a clock per SM at the clock of the bf16 peak (1.83 GHz)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs / (SFU_EX2_PER_CLOCK * sms * TENSOR_CLOCK_HZ) * 1e3


def mirror_tile_counts(masks, b, h, hk, s, causal, d, fp32=False):
    """[visited, elementwise, candidates] of the masked forward, dK/dV and
    dQ kernels (with ``fp32``, csrc/flash_fp32.cu's at their tiles) by
    fwd.py's and bwd.py's mirrors of their producers: the tiles visited,
    those of them with the elementwise test, and the unmasked plan's
    tiles."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        kernel_tiles)
    counts = []
    window = (-1, 0 if causal else -1)
    if fp32:
        rows_dkv, keys_dkv = kernel_tiles("dkv_fp32", d)
        dense = (fwd.key_tile_plan(s, s, causal, 128,
                                   kernel_tiles("fwd_fp32", d)[1]),
                 [bwd.query_tile_order(*bwd.query_window(
                     n0, s, s, window, rows_dkv, keys_dkv))
                  for n0 in range(0, s, keys_dkv)],
                 fwd.key_tile_plan(s, s, causal, 128,
                                   kernel_tiles("dq_fp32", d)[1]))
    else:
        dense = (fwd.fwd_tile_plan(s, s, causal),
                 bwd.bwd_dkv_tile_plan(s, s, causal),
                 bwd.bwd_dq_tile_plan(s, s, causal, d))
    for plan, cands in (
            (fwd.fwd_masked_tile_plan(masks, b, h, s, s, causal, d, fp32),
             b * h * sum(map(len, dense[0]))),
            (bwd.bwd_masked_dkv_tile_plan(masks, b, h, hk, s, s, causal, d,
                                          fp32),
             b * h * sum(map(len, dense[1]))),
            (bwd.bwd_masked_dq_tile_plan(masks, b, h, hk, s, s, causal, d,
                                         fp32),
             b * h * sum(map(len, dense[2])))):
        tiles = [e for es in plan.values() for e in es]
        counts.append([len(tiles), sum(1 for e in tiles if e[-2]), cands])
    return counts


def check_sparse_kernels(gen, label, shape, causal, make_flags,
                         window=(-1, -1)):
    """Phase 3 rows of the forward (#1) and of the dK/dV (#2) and dQ (#3)
    kernels under a sparse mask, a window, segment ids or positions at
    ``shape`` (the flags resolved as the entry resolves them,
    fwd.build_masks): each against its plain
    version with the dense mask on the same inputs (by kv-head groups),
    timed (CUDA events, warmed, the mask's kernel arguments made once, as
    the backward rows always did), with bounds from the visible pairs and
    SDPA with the dense mask as the library call. The timed launches write
    into buffers filled with NaN first and must give the checked outputs
    bit for bit; the tiles they visit, as the kernels count them, must
    equal fwd.py's and bwd.py's mirrors."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, common, fwd)
    b, h, hk, s, d = _dims(shape)
    q, k, v, do = _sparse_inputs(gen, shape)
    flags = make_flags(gen)
    eff, masks = fwd.build_masks(b, h, s, s, causal, window, **flags)
    dense = masks.keep(h, "cuda")
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw,
                                       masks=masks)
    ref, ref_lse = plain_fwd_groups(q, k, v, dense, **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = BF16_ULP * ref.float().abs().max().item() + 1e-3
    fin = torch.isfinite(ref_lse)
    check(torch.equal(fin, torch.isfinite(lse)),
          f"flash_fwd ({label}): rows with no key differ")
    check(not out[~fin].float().abs().any(),
          f"flash_fwd ({label}): a row with no key is not 0")
    err_lse = max_err(lse[fin], ref_lse[fin])
    check(err <= tol and err_lse <= 1e-3,
          f"flash_fwd ({label}): err {err} > {tol} or lse err {err_lse}")
    del ref, ref_lse
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw, masks=masks)
    want = plain_bwd_groups(q, k, v, out, lse, do, dense, **kw)
    torch.cuda.synchronize()
    err_dq = max_err(grads[0], want[0])
    err_dkv = max(max_err(grads[1], want[1]), max_err(grads[2], want[2]))
    gtol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(max(err_dq, err_dkv) <= gtol,
          f"flash_bwd ({label}): err vs plain {err_dq}, {err_dkv} > {gtol}")
    del want
    keep = _causal_part(dense, eff, s, s)
    n_vis = visible_pairs(keep, b, h)
    share = n_vis / (b * h * s * s)
    lib_fwd, lib_bwd = _sdpa_masked_ms(q, k, v, do, keep)
    del keep
    io = 2.0 * b * s * d * (2 * h + 2 * hk)  # q, o | do and k, v (bf16)
    shape_txt = (f"b{b} h{h} hk{hk} s{s} d{d} "
                 f"{'causal' if causal else 'full'}"
                 + (f", window {window}" if window != (-1, -1) else ""))
    masks.bands()  # made once, as the stats
    fwd_out = torch.full_like(out, float("nan"))
    fwd_counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fwd.launch_flash_fwd(q, k, v, fwd_out, None, masks=masks,
                         tile_counts=fwd_counts, **kw)
    torch.cuda.synchronize()
    check(torch.equal(fwd_out, out),
          f"flash_fwd ({label}): the timed launch differs from the checked "
          "output")
    bms, by = bound(2 * 2 * d * n_vis, PEAK_BF16_FLOPS, io)
    entry_ms = time_ms([lambda: fwd.flash_attention_fwd(
        q, k, v, need_lse=False, sm_scale=kw["sm_scale"], causal=causal,
        window_size=window, **flags)])
    rows = [dict(
        name=f"flash_fwd ({label})", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78",
        max_abs_err=err,
        ms=time_ms([lambda: fwd.launch_flash_fwd(
            q, k, v, fwd_out, None, masks=masks, **kw)]),
        plain_ms=time_ms([lambda: plain_fwd_groups(q, k, v, dense, **kw)],
                         iters=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=lib_fwd)]
    report(rows[0], f"tol {tol:.3g} = 1 bf16 ulp of max|out| + 1e-3; lse "
                    f"err {err_lse:.3g}; {shape_txt}, visible share "
                    f"{share:.4f}, flops {4 * d * n_vis:.4g}; exponent floor "
                    f"{exp_floor_ms(n_vis):.4f} ms; the kernel alone (through "
                    f"flash_attention_fwd, the mask arguments made per call: "
                    f"{entry_ms:.4f} ms); library: SDPA with the dense boolean "
                    "mask")
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in grads)
    args = (qs, k, v, do, lse, delta, dq, dk, dv)
    counted = []
    for fn in (bwd.flash_bwd_dkv, bwd.flash_bwd_dq):
        counts = torch.zeros(3, dtype=torch.int32, device="cuda")
        fn(*args, masks=masks, tile_counts=counts, **kw)
        counted.append(counts[1:].tolist())
    counted.insert(0, fwd_counts[1:].tolist())
    mirror = mirror_tile_counts(masks, b, h, hk, s, eff, d)
    check(counted == [m[:2] for m in mirror],
          f"flash_fwd / flash_bwd ({label}): the kernels visited {counted} "
          f"tiles (visited, elementwise), the mirrors {mirror}")
    print(f"  tile plan ({label}, counted by the kernels, equal to fwd.py's "
          "and bwd.py's mirrors): " + "; ".join(
              f"{name} {n} visited ({e} elementwise), {c - n} of {c} skipped"
              for name, (n, e, c) in zip(("forward", "dK/dV", "dQ"), mirror)),
          flush=True)
    stats = 2 * 4.0 * b * h * s  # lse, delta (fp32)
    plain_ms = time_ms([lambda: plain_bwd_groups(
        q, k, v, out, lse, do, dense, **kw)], iters=2, warmup=1)
    bwd_rows = []
    for name, fn, n_mm, out_bytes, e in (
            ("flash_bwd_dkv", bwd.flash_bwd_dkv, 4, 2 * 2.0 * b * s * hk * d,
             err_dkv),
            ("flash_bwd_dq", bwd.flash_bwd_dq, 3, 2.0 * b * s * h * d, err_dq)):
        bms, by = bound(n_mm * 2 * d * n_vis, PEAK_BF16_FLOPS,
                        io + stats + out_bytes)
        row = dict(
            name=f"{name} ({label})", route="cuda",
            source="xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu",
            replaces=("xhy_flash_attention_tpu/ops/flash_attention/bwd.py:180"
                      if name == "flash_bwd_dkv" else
                      "xhy_flash_attention_tpu/ops/flash_attention/bwd.py:511"),
            max_abs_err=e,
            ms=time_ms([lambda fn=fn: fn(*args, masks=masks, **kw)], iters=10),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_bwd)
        report(row, f"tol {gtol:.3g} = 4 bf16 ulp of max|grad| vs the plain "
                    f"backward; {shape_txt}, visible share {share:.4f}, "
                    f"{n_mm} products over the visible pairs (flops "
                    f"{n_mm * 2 * d * n_vis:.4g}); plain_ms and library_ms "
                    "are of the whole backward (library: SDPA with the dense mask, "
                    "fwd + bwd minus fwd)")
        bwd_rows.append(row)
    check(all(torch.equal(a, c) for a, c in zip((dq, dk, dv), grads)),
          f"flash_bwd ({label}): the timed launches differ from the checked "
          "gradients")
    summed = bwd_rows[0]["ms"] + bwd_rows[1]["ms"]
    bms, by = bound(5 * 2 * d * n_vis, PEAK_BF16_FLOPS,
                    io + stats + 2.0 * b * s * d * (h + 2 * hk))
    print(f"  attention backward ({label}): dK/dV + dQ {summed:.4f} ms against "
          f"the 5-product bound of the visible pairs {bms:.4f} ms by {by} "
          f"(share {bms / summed:.3f}); SDPA backward with the mask "
          f"{lib_bwd:.4f} ms", flush=True)
    return rows + bwd_rows


def doc_cu_seqlens(gen, total, lo, hi):
    """cu_seqlens (n + 1,) int32 on the card of documents whose lengths are
    drawn uniformly in [lo, hi] from ``gen``, the last one cut at
    ``total`` (set-up: the count of documents is read on the host)."""
    lens = torch.randint(lo, hi + 1, (total // lo + 1,), generator=gen,
                         device="cuda")
    cu = torch.cumsum(lens, 0)
    n = int((cu < total).sum().item()) + 1
    zero = torch.zeros(1, dtype=cu.dtype, device="cuda")
    return torch.cat([zero, cu[:n].clamp(max=total)]).to(torch.int32)


def vl_flags(cu_q, cu_k, tq, tk):
    """The segment ids and bottom-right aligned positions that
    `flash_attn_varlen_func` makes from cu_seqlens under a causal mask (its
    own helpers), as kernel flags over a batch of 1."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import interface
    lq, seq = interface._local_positions(cu_q, tq)
    lk, _ = interface._local_positions(cu_k, tk)
    off = ((cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1]))[seq]
    return dict(
        q_segment_ids=interface._segment_ids_from_cu_seqlens(cu_q, tq)[None],
        kv_segment_ids=interface._segment_ids_from_cu_seqlens(cu_k, tk)[None],
        q_positions=(lq + off)[None], kv_positions=lk[None])


def doc_ids(cu, total):
    """(1, total) document index of each packed token."""
    t = torch.arange(total, dtype=torch.int32, device="cuda")
    return (torch.searchsorted(cu, t, right=True) - 1)[None]


def check_sw_vs_flashmask(gen):
    """SW's window (4095, 0) and the FlashMask route of
    `sliding_window_mask(b, s, 4096)` compute the same function: their
    outputs and LSE on the same inputs agree to one bf16 unit of the
    largest output (+1e-3; the two kernels visit the tiles in another
    order), and both kernels are timed (mask arguments made once), beside
    the dense causal kernel at the same shape (PERF.md's prediction: the
    window keeps 0.75 of the causal pairs)."""
    from xhy_flash_attention_tpu_torch import sliding_window_mask
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    b, h, hk, s, d = _dims(SW)
    q, k, v, _ = _sparse_inputs(gen, SW)
    kw = dict(sm_scale=d ** -0.5, softcap=0.0)
    eff, win = fwd.build_masks(b, h, s, s, True, SW_WINDOW)
    eff_fm, fm = fwd.build_masks(**dict(b=b, h=h, sq=s, sk=s, causal=True),
                                 **_flags(sliding_window_mask(
                                     b, s, SW_WINDOW[0] + 1), causal=True))
    outs = []
    for c, m in ((eff, win), (eff_fm, fm)):
        outs.append(fwd.flash_attention_fwd(q, k, v, causal=c, masks=m, **kw))
    torch.cuda.synchronize()
    err = max_err(outs[0][0], outs[1][0])
    err_lse = max_err(outs[0][1], outs[1][1])
    tol = BF16_ULP * outs[1][0].float().abs().max().item() + 1e-3
    check(err <= tol and err_lse <= 1e-3,
          f"SW window vs FlashMask sliding window: err {err} > {tol} or lse "
          f"err {err_lse}")
    o = torch.empty_like(outs[0][0])
    ms = [time_ms([lambda c=c, m=m: fwd.launch_flash_fwd(
        q, k, v, o, None, causal=c, masks=m, **kw)]) for c, m in
        ((eff, win), (eff_fm, fm), (True, None))]
    print(f"  SW (window {SW_WINDOW}) vs FlashMask sliding_window_mask("
          f"{SW_WINDOW[0] + 1}) on the same inputs: max |difference| "
          f"{err:.4g} (tol {tol:.3g}), lse {err_lse:.3g}; window route "
          f"{ms[0]:.4f} ms, FlashMask route {ms[1]:.4f} ms; the dense causal "
          f"kernel at this shape {ms[2]:.4f} ms (window / dense "
          f"{ms[0] / ms[2]:.3f})", flush=True)


def check_reduced(gen):
    """Phase 3 row of the reduced-scores kernel (#12) at FM-swg's shape, on
    the LSE of FM-swg's masked forward: against the plain version (same
    bf16 values; its q . k an fp32 product summed in another order: 1e-4
    of the largest score), bitwise equal across two launches. No single
    PyTorch call computes the function: library_ms is null."""
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        fwd, reduced_scores as rs)
    b, h, hk, s, d = _dims(FM_SWG)
    q, k, v, _ = _sparse_inputs(gen, FM_SWG)
    flags = _flags(global_sliding_window_mask(b, s, SWG_WINDOW, SWG_GLOBAL),
                   causal=True)
    _, lse = fwd.flash_attention_fwd(q, k, v, sm_scale=d ** -0.5, causal=True,
                                     **flags)
    got = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    again = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    want = rs.reduced_scores_ref(q, k, lse, sm_scale=d ** -0.5, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "reduced_scores: two launches differ")
    err = max_err(got, want)
    tol = 1e-4 * want.abs().max().item()
    check(err <= tol, f"reduced_scores err {err} > {tol}")
    del want
    n_vis = b * h * s * (s + 1) / 2.0  # the causal region
    nbytes = 2.0 * b * s * d * (h + hk) + 4.0 * b * h * s * 2  # q, k | lse, out
    bms, by = bound(2 * d * n_vis, PEAK_BF16_FLOPS, nbytes)
    row = dict(
        name="reduced_scores", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/reduced_scores.cu",
        replaces=("xhy_flash_attention_tpu/ops/flash_attention/"
                  "reduced_scores.py:34"),
        max_abs_err=err,
        ms=time_ms([lambda: rs.calc_reduced_attn_scores(q, k, lse,
                                                        causal=True)]),
        plain_ms=time_ms([lambda: rs.reduced_scores_ref(
            q, k, lse, sm_scale=d ** -0.5, causal=True)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    report(row, f"tol {tol:.3g} = 1e-4 of max|score|; two launches bitwise "
                f"equal; b{b} h{h} hk{hk} s{s} d{d} causal, flops "
                f"{2 * d * n_vis:.4g}; exponent floor "
                f"{exp_floor_ms(n_vis):.4f} ms beside the ops bound; library: "
                "none (no single PyTorch call computes it)")
    return row


def plain_attention(q, k, v, do, causal, keep, upcast):
    """The plain forward and backward with the dense keep mask (no causal
    part), in fp32 (``upcast``) or in the inputs' bf16, a group of kv heads
    at a time: out, lse, dq, dk, dv."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, common, fwd)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    keep = common.expand_heads(keep, h)
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    cast = (lambda t: t.float()) if upcast else (lambda t: t)
    parts = []
    for j in range(0, hk, step):
        hs, ks = slice(j * g, (j + step) * g), slice(j, j + step)
        qc, kc, vc, dc = cast(q[:, hs]), cast(k[:, ks]), cast(v[:, ks]), \
            cast(do[:, hs])
        kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0,
                  mask=keep if keep.shape[1] == 1 else keep[:, hs])
        o, lse = fwd.attention_fwd_ref(qc, kc, vc, need_lse=True, **kw)
        parts.append((o, lse) + bwd.attention_bwd_ref(qc, kc, vc, o, lse, dc,
                                                      **kw))
    return [torch.cat(p, 1) for p in zip(*parts)]


def entry_launches(dtype, reduced=False):
    """The launches of one forward and backward through an attention entry
    in ``dtype`` (bf16: csrc/flash_fwd.cu and flash_bwd.cu; fp32:
    csrc/flash_fp32.cu), and of a reduced-scores call when ``reduced``."""
    f32 = dtype == torch.float32
    return {**{key: 0 for key in counters()},
            "flash_fwd_fp32" if f32 else "flash_fwd (flash_attention_fwd)": 1,
            "flash_bwd_prep": 1,
            "flash_bwd_dkv_fp32" if f32 else "flash_bwd_dkv": 1,
            "flash_bwd_dq_fp32" if f32 else "flash_bwd_dq": 1,
            "reduced_scores": int(reduced)}


def entry_errors(name, got, ref, low):
    """Each of out, the finite LSE and the gradients (``got``, None where
    absent) against the fp32 plain version ``ref``: bf16 within twice the
    bf16 plain version's (``low``) error, + 1e-4 (out, LSE) or 1e-3; fp32
    (``low`` None) within 1e-4 of the largest |ref| + 1e-5 (the kernels'
    three TF32 products against the plain fp32 products; the contract
    against float64 is phase 3's). Returns {what: (err, bf16 plain err or
    the fp32 tolerance)}."""
    errs = {}
    for i, (what, g) in enumerate(zip(("out", "lse", "dq", "dk", "dv"), got)):
        if g is None:
            continue
        w, lo = ref[i], None if low is None else low[i]
        if what == "lse":
            fin = torch.isfinite(w)
            check(torch.equal(fin, torch.isfinite(g)),
                  f"{name}: rows with no key differ")
            g, w, lo = g[fin], w[fin], None if lo is None else lo[fin]
        e = max_err(g, w)
        if lo is None:
            tol = 1e-4 * w.abs().max().item() + 1e-5
            errs[what] = (e, tol)
            check(e <= tol, f"{name} {what}: err vs fp32 plain {e} > {tol}")
        else:
            e_lp = max_err(lo, w)
            errs[what] = (e, e_lp)
            check(e <= 2 * e_lp + (1e-4 if what in ("out", "lse") else 1e-3),
                  f"{name} {what}: err vs fp32 plain {e} > 2 x bf16 plain "
                  f"{e_lp}")
    return errs


def sparse_case(gen, name, shape, causal, indices=None, block_mask=None,
                reduced=False, dtype=torch.bfloat16):
    """Phase 11, one case: forward and backward through the public entry
    (`flashmask_attention` or `blocksparse_attention`, an autograd
    function), and `calc_reduced_attn_scores` on its LSE when ``reduced``;
    launches exact; in bf16 the contract of the fp32 plain version against
    the bf16 plain version on out, the finite LSE and every gradient, in
    fp32 (``dtype``) the fp32 kernels against the fp32 plain version
    (entry_errors); a second pass bitwise equal. Returns its launches by
    kernel."""
    from xhy_flash_attention_tpu_torch import (
        blocksparse_attention, calc_reduced_attn_scores, flashmask_attention)
    from xhy_flash_attention_tpu_torch.ops.flash_attention import common
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        reduced_scores as rs
    b, h, hk, s, d = _dims(shape)
    q, k, v, do = _sparse_inputs(gen, shape, dtype)
    flags = _flags(indices, causal, block_mask)

    def run():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        if indices is not None:
            out, lse = flashmask_attention(*ins, indices, causal=causal,
                                           return_lse=True)
        else:
            out, lse = blocksparse_attention(*ins, block_mask,
                                             block_size=BS_BLOCK), None
        grads = torch.autograd.grad(out, ins, do)
        red = (calc_reduced_attn_scores(q, k, lse, causal=True)
               if reduced else None)
        return out.detach(), lse, grads, red

    torch.cuda.synchronize()
    reset_counts()
    out, lse, grads, red = run()
    torch.cuda.synchronize()
    counts = read_counts()
    want = entry_launches(dtype, reduced)
    check(counts == want, f"{name}: launches {counts} != {want}")
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
          f"{name}: non-finite output or gradient")
    keep = common.dense_keep_mask(s, s, h, **flags)
    share = visible_pairs(_keep(flags, causal, h, s, s), b, h) / (b * h * s * s)
    ref = plain_attention(q, k, v, do, causal, keep, upcast=True)
    low = (plain_attention(q, k, v, do, causal, keep, upcast=False)
           if dtype == torch.bfloat16 else None)
    errs = entry_errors(name, (out, lse, *grads), ref, low)
    del ref, low
    out2, _, grads2, red2 = run()
    check(torch.equal(out, out2) and all(torch.equal(a, c) for a, c in
                                         zip(grads, grads2)),
          f"{name}: a second pass is not bitwise equal")
    against = "bf16 plain" if dtype == torch.bfloat16 else "tol"
    line = (f"  {name}: b{b} h{h} hk{hk} s{s} d{d} "
            f"{'causal' if causal else 'full'}, visible share {share:.4f}; "
            + ", ".join(f"{w_} err {e:.3g} ({against} {e_lp:.3g})"
                        for w_, (e, e_lp) in errs.items())
            + "; second pass bitwise equal")
    if reduced:
        check(torch.equal(red, red2), f"{name}: reduced scores differ")
        fin = torch.isfinite(lse)
        want_red = torch.cat([rs.reduced_scores_ref(
            q[:, i:i + h // hk], k[:, j:j + 1], lse[:, i:i + h // hk],
            sm_scale=d ** -0.5, causal=True)
            for j, i in enumerate(range(0, h, h // hk))], 1)
        e = max_err(red, want_red)
        tol = 1e-4 * want_red.abs().max().item()
        check(e <= tol and bool(fin.all()), f"{name} reduced scores err {e}")
        line += (f"; reduced scores err {e:.3g} (tol {tol:.3g}), bitwise "
                 "equal across two runs")
    ms = time_ms([run], iters=3, warmup=1)
    print(line + f"; fwd + bwd{' + reduced' if reduced else ''} {ms:.4f} ms; "
          f"launches {json.dumps({k_: v_ for k_, v_ in counts.items() if v_})}",
          flush=True)
    return counts


def sparse_masks(gen):
    """Phase 11: the four sparse-mask cases at full width. Returns the
    launches of each phase 3 row on this path."""
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    fm, bs = {}, {}

    def add(into, counts):
        for k_, v_ in counts.items():
            into[k_] = into.get(k_, 0) + v_

    b, _, _, s, _ = _dims(FM_DOC)
    add(fm, sparse_case(gen, "FM-doc", FM_DOC, True,
                        indices=doc_indices(gen, b, s)))
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(FM_SWG)
    swg = sparse_case(gen, "FM-swg", FM_SWG, True,
                      indices=global_sliding_window_mask(
                          b, s, SWG_WINDOW, SWG_GLOBAL), reduced=True)
    add(fm, swg)
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(FM_FULL)
    for nv in (2, 4):
        add(fm, sparse_case(gen, f"FM-full (full_{nv}, hm {FM_FULL_HEADS})",
                            FM_FULL, False, indices=random_bands(
                                gen, nv, b, FM_FULL_HEADS, s)))
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(BS)
    add(bs, sparse_case(gen, "BS", BS, False,
                        block_mask=bigbird_mask(gen, b, s // BS_BLOCK)))
    torch.cuda.empty_cache()
    rows = fp32_sparse_masks(gen)
    for label, c in (("FlashMask", fm), ("block-sparse", bs)):
        rows[f"flash_fwd ({label})"] = c["flash_fwd (flash_attention_fwd)"]
        rows[f"flash_bwd_dkv ({label})"] = c["flash_bwd_dkv"]
        rows[f"flash_bwd_dq ({label})"] = c["flash_bwd_dq"]
    rows["flash_fwd (FM-swg)"] = swg["flash_fwd (flash_attention_fwd)"]
    rows["flash_bwd_dkv (FM-swg)"] = swg["flash_bwd_dkv"]
    rows["flash_bwd_dq (FM-swg)"] = swg["flash_bwd_dq"]
    rows["reduced_scores"] = fm["reduced_scores"]
    return rows


def own_gen(gen, offset):
    """A generator of its own, seeded from ``gen``'s seed + ``offset``: the
    fp32 masked cases draw from it, so that every earlier phase
    draws what it drew before."""
    return torch.Generator(device="cuda").manual_seed(gen.initial_seed()
                                                      + offset)


def fp32_sparse_masks(gen):
    """Phase 11's fp32 cases: FM-doc, FM-swg with the reduced
    scores of its LSE, and BS, in float32 through the same entries (the
    masked instantiations of csrc/flash_fp32.cu). Returns the launches of
    each phase 3 fp32 row on this path."""
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    f32, rows, gen = torch.float32, {}, own_gen(gen, 1811)
    b, _, _, s, _ = _dims(FM_DOC)
    cases = (("FM-doc-fp32", FM_DOC, True,
              dict(indices=doc_indices(gen, b, s))),)
    b, _, _, s, _ = _dims(FM_SWG)
    cases += (("FM-swg-fp32", FM_SWG, True, dict(
        indices=global_sliding_window_mask(b, s, SWG_WINDOW, SWG_GLOBAL),
        reduced=True)),)
    b, _, _, s, _ = _dims(BS)
    cases += (("BS-fp32", BS, False, dict(
        block_mask=bigbird_mask(gen, b, s // BS_BLOCK))),)
    for label, shape, causal, kw in cases:
        counts = sparse_case(gen, label, shape, causal, dtype=f32, **kw)
        for row in ("flash_fwd_fp32", "flash_bwd_dkv_fp32",
                    "flash_bwd_dq_fp32"):
            rows[f"{row} ({label})"] = counts[row]
        if kw.get("reduced"):
            rows["reduced_scores (fp32, FM-swg-fp32)"] = \
                counts["reduced_scores"]
        torch.cuda.empty_cache()
    return rows


# ------------------------------------- phase 12: a Mistral-7B-width model

def window_binds(model, gen):
    """The last position's logits of request W's prompt length through the
    windowed model and through the same weights with no window differ by
    more than the kernel-vs-plain gate (LOGIT_TOL): a window that were
    silently ignored would give the same logits. The prompt's first half
    repeats one token, its second half is random: under a window of 4096
    the last position no longer sees the first half."""
    _, prompt, _ = MISTRAL_REQUESTS["W"]
    half = prompt // 2
    vocab = model.config.vocab_size
    ids = torch.cat([torch.full((1, half), 7, device="cuda"),
                     torch.randint(0, vocab, (1, prompt - half),
                                   generator=gen, device="cuda")], 1)
    mixers = [layer.mixer for layer in model.transformer.layers]
    saved = [m.window_size for m in mixers]
    with torch.inference_mode():
        win = model(ids)[0][:, -1].float()
        try:
            for m in mixers:
                m.window_size = (-1, -1)
            full = model(ids)[0][:, -1].float()
        finally:
            for m, w in zip(mixers, saved):
                m.window_size = w
    diff = (win - full).abs().max().item()
    print(f"  request W's window binds: last-position logits with window "
          f"{saved[0]} vs none differ by {diff:.4g} (must exceed the gate "
          f"{LOGIT_TOL}); the window keeps "
          f"{1 - (prompt - 4096) * (prompt - 4096 + 1) / (prompt * (prompt + 1)):.4f} "
          "of the causal pairs at this length", flush=True)
    check(diff > LOGIT_TOL, f"the window does not bind: {diff} <= {LOGIT_TOL}")
    return diff


def mistral_serving(seed, gen):
    """Phase 12: the Mistral-7B-width model (MISTRAL_7B through
    llama_config_to_gpt_config; random bf16 weights from the seed) serves
    request W (serve: eager and graph, exact launches, no plain version
    called, graph tokens equal to eager tokens), its kernel path is held to the plain path
    (kernel_vs_plain; the plain attention by kv-head groups), and the
    window must bind (window_binds). Returns the graph run's launches."""
    from xhy_flash_attention_tpu_torch import (GPTLMHeadModel,
                                               llama_config_to_gpt_config)
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import \
        resolve_window
    cfg = llama_config_to_gpt_config(types.SimpleNamespace(**MISTRAL_7B),
                                     torch.bfloat16)
    _, prompt, _ = MISTRAL_REQUESTS["W"]
    check(cfg.window_size == SW_WINDOW,
          f"Mistral's window maps to {cfg.window_size}")
    plain_causal, window, _ = resolve_window(True, cfg.window_size, prompt,
                                             prompt, False)
    check(window == SW_WINDOW and not plain_causal,
          "request W's prefill must take the windowed forward")
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params / 1e9:.3f} B parameters built in "
          f"{time.perf_counter() - t0:.1f} s; window_size {cfg.window_size}",
          flush=True)
    with count_plain_calls() as plain:
        counts, _, _ = serve(model, gen, "W")
    check(not plain, f"request W: plain versions ran on the main path: "
                     f"{plain}")
    check(counts["flash_fwd (flash_attention_fwd)"] == LAYERS,
          f"request W's prefill launched the windowed forward "
          f"{counts['flash_fwd (flash_attention_fwd)']} times, not {LAYERS}")
    torch.cuda.empty_cache()
    kernel_vs_plain(model, gen, "W")
    torch.cuda.empty_cache()
    window_binds(model, gen)
    del model
    torch.cuda.empty_cache()
    return counts


# ----------------------------------- phase 13: varlen and windowed entries

def varlen_case(gen, name, shape, lengths=None, window=(-1, -1),
                kvpacked=False, dtype=torch.bfloat16):
    """Phase 13, one case: forward and backward through a public entry,
    causal: `flash_attn_varlen_func` (or, with ``kvpacked``,
    `flash_attn_varlen_kvpacked_func` on one (total, 2, hk, d) kv tensor)
    over documents with lengths drawn in ``lengths``, or
    `flash_attention` under ``window``; launches exact and no plain
    version called; the contract of
    the fp32 plain version against the bf16 plain version (the same dense
    mask, by kv-head groups) on out, the finite LSE and every gradient; a
    second pass bitwise equal; fwd + bwd ms beside SDPA with the dense
    mask and, for a varlen case without kv packing, the FlashMask route
    (causal_document_mask) on the same documents. In fp32 (``dtype``) the
    fp32 kernels against the fp32 plain version (entry_errors). Returns its
    launches."""
    from xhy_flash_attention_tpu_torch import (
        causal_document_mask, flash_attention, flash_attn_varlen_func,
        flash_attn_varlen_kvpacked_func, flashmask_attention)
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    b, h, hk, s, d = _dims(shape)
    q, k, v, do = _sparse_inputs(gen, shape, dtype)
    flags, cu = {}, None
    if lengths is not None:
        cu = doc_cu_seqlens(gen, s, *lengths)
        flags = vl_flags(cu, cu, s, s)
    eff, masks = fwd.build_masks(b, h, s, s, True, window, **flags)
    keep = _causal_part(masks.keep(h, "cuda"), eff, s, s)
    # the entries' layouts: varlen (total, heads, d) views of the same
    # memory; kv packed into one tensor (a copy made once)
    lay = (lambda t: t[0].transpose(0, 1)) if cu is not None else \
        (lambda t: t)
    kv = torch.stack([lay(k), lay(v)], 1) if kvpacked else None

    def run():
        if kvpacked:
            ins = [lay(q).detach().requires_grad_(),
                   kv.detach().requires_grad_()]
            out = flash_attn_varlen_kvpacked_func(ins[0], ins[1], cu, cu, s,
                                                  s, causal=True)
            lse = None
        elif cu is not None:
            ins = [lay(t).detach().requires_grad_() for t in (q, k, v)]
            out, lse = flash_attn_varlen_func(*ins, cu, cu, s, s, causal=True,
                                              return_lse=True)
            lse = lse[None]
        else:
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out, lse = flash_attention(*ins, causal=True, window_size=window,
                                       return_lse=True)
        grads = torch.autograd.grad(out, ins, lay(do))
        if kvpacked:
            grads = (grads[0], grads[1][:, 0], grads[1][:, 1])
        back = (lambda t: t.transpose(0, 1)[None]) if cu is not None else \
            (lambda t: t)
        return back(out.detach()), lse, [back(g) for g in grads]

    torch.cuda.synchronize()
    reset_counts()
    with count_plain_calls() as plain:
        out, lse, grads = run()
    torch.cuda.synchronize()
    counts = read_counts()
    want = entry_launches(dtype)
    check(counts == want, f"{name}: launches {counts} != {want}")
    check(not plain, f"{name}: plain versions ran: {plain}")
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
          f"{name}: non-finite output or gradient")
    share = visible_pairs(keep, b, h) / (b * h * s * s)
    ref = plain_attention(q, k, v, do, eff, keep, upcast=True)
    low = (plain_attention(q, k, v, do, eff, keep, upcast=False)
           if dtype == torch.bfloat16 else None)
    errs = entry_errors(name, (out, lse, *grads), ref, low)
    del ref, low
    out2, _, grads2 = run()
    check(torch.equal(out, out2) and all(torch.equal(a, c) for a, c in
                                         zip(grads, grads2)),
          f"{name}: a second pass is not bitwise equal")
    ms = time_ms([run], iters=3, warmup=1)
    lib_fwd, lib_bwd = _sdpa_masked_ms(q, k, v, do, keep)
    line = (f"  {name}: b{b} h{h} hk{hk} s{s} d{d} causal"
            + (f", {cu.numel() - 1} documents of {lengths[0]}-{lengths[1]}"
               if cu is not None else f", window {window}")
            + f", visible share {share:.4f}; "
            + ", ".join(f"{w_} err {e:.3g} ("
                        f"{'bf16 plain' if dtype == torch.bfloat16 else 'tol'}"
                        f" {e_lp:.3g})" for w_, (e, e_lp) in errs.items())
            + f"; second pass bitwise equal; fwd + bwd {ms:.4f} ms; SDPA "
            f"with the dense mask fwd + bwd {lib_fwd + lib_bwd:.4f} ms")
    if cu is not None and not kvpacked:
        idx = causal_document_mask(doc_ids(cu, s))

        def run_fm():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o = flashmask_attention(*ins, idx, causal=True)
            return o, torch.autograd.grad(o, ins, do)
        fm_out, _ = run_fm()
        torch.cuda.synchronize()
        fm_err = max_err(fm_out, out)
        tol = ((BF16_ULP if dtype == torch.bfloat16 else 1e-4)
               * out.float().abs().max().item()
               + (1e-3 if dtype == torch.bfloat16 else 1e-5))
        check(fm_err <= tol, f"{name}: the FlashMask route differs by "
                             f"{fm_err} > {tol}")
        line += (f"; the FlashMask route on the same documents (FM-doc's "
                 f"causal_document_mask) fwd + bwd "
                 f"{time_ms([run_fm], iters=3, warmup=1):.4f} ms, its output "
                 f"within {fm_err:.3g} (tol {tol:.3g})")
    print(line + f"; launches "
          f"{json.dumps({k_: v_ for k_, v_ in counts.items() if v_})}",
          flush=True)
    return counts


def varlen_entries(gen):
    """Phase 13: VL-doc, VL-gqa and SW. Returns the launches of each phase
    3 row of the window and segment / position routes on this path."""
    rows = {}
    for name, shape, kw in (
            ("VL-doc", VL_DOC, dict(lengths=VL_DOC_LENGTHS)),
            ("VL-gqa", VL_GQA, dict(lengths=VL_GQA_LENGTHS, kvpacked=True)),
            ("SW", SW, dict(window=SW_WINDOW)),
            ("VL-doc-fp32", VL_DOC, dict(lengths=VL_DOC_LENGTHS,
                                         dtype=torch.float32))):
        counts = varlen_case(own_gen(gen, 1813) if name.endswith("fp32")
                             else gen, name, shape, **kw)
        label = {"SW": "SW", "VL-doc-fp32": "VL-doc-fp32"}.get(name, "VL-doc")
        keys = ((("flash_fwd_fp32", "flash_fwd_fp32"),
                 ("flash_bwd_dkv_fp32", "flash_bwd_dkv_fp32"),
                 ("flash_bwd_dq_fp32", "flash_bwd_dq_fp32"))
                if name.endswith("fp32") else
                (("flash_fwd (flash_attention_fwd)", "flash_fwd"),
                 ("flash_bwd_dkv", "flash_bwd_dkv"),
                 ("flash_bwd_dq", "flash_bwd_dq")))
        for key, row in keys:
            rows[f"{row} ({label})"] = rows.get(f"{row} ({label})", 0) + \
                counts[key]
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------- phase 14: attention bias

# (label, shape, bias kind): Llama-3-8B width's attention with a shared
# (1, 1, s, s) bias (a relative-position table), the reference C API's
# attn_mask as PaddlePaddle passes it (b, 1, s, s) and a per-head (b, h, s,
# s) one; T-long's attention with a batch-broadcast (1, h, s, s) bias
BIAS_CASES = (("A shared", T_GQA, "shared"), ("A attn_mask", T_GQA, "batch"),
              ("A per-head", T_GQA, "head"), ("T-long heads", T_LONG,
                                              "heads"))
BIAS_ROWS = (("flash_fwd", "flash_fwd.cu", "fwd.py:78"),
             ("flash_bwd_dkv", "flash_bwd.cu", "bwd.py:180"),
             ("flash_bwd_dq", "flash_bwd.cu", "bwd.py:511"),
             ("flash_bwd_dbias", "flash_bwd_dbias.cu", "bwd.py:180"))


def bias_shape(kind, b, h, s):
    return {"shared": (1, 1, s, s), "batch": (b, 1, s, s),
            "head": (b, h, s, s), "heads": (1, h, s, s)}[kind]


def plain_bias_attention(q, k, v, do, bias, upcast):
    """The plain causal forward and backward with a (bb, bh, s, s) bias, in
    fp32 (``upcast``) or in the inputs' bf16, a group of kv heads at a time
    (PLAIN_CHUNK_BYTES): out, lse, dq, dk, dv and dbias summed over the
    axes the bias broadcasts."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    cast = (lambda t: t.float()) if upcast else (lambda t: t)
    parts, dbias = [], None
    for j in range(0, hk, step):
        hs, ks = slice(j * g, (j + step) * g), slice(j, j + step)
        bc = bias if bias.shape[1] == 1 else bias[:, hs]
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0, bias=bc)
        qc, kc, vc, dc = (cast(t) for t in (q[:, hs], k[:, ks], v[:, ks],
                                             do[:, hs]))
        o, lse = fwd.attention_fwd_ref(qc, kc, vc, need_lse=True, **kw)
        dq, dk, dv, db = bwd.attention_bwd_ref(qc, kc, vc, o, lse, dc, **kw)
        parts.append((o, lse, dq, dk, dv))
        if bias.shape[1] > 1:
            dbias = db if dbias is None else torch.cat([dbias, db], 1)
        else:
            db = db.sum(1, keepdim=True) if db.shape[1] > 1 else db
            dbias = db if dbias is None else dbias + db
    return [torch.cat(p, 1) for p in zip(*parts)] + [dbias]


def _sdpa_bias_ms(q, k, v, do, bias):
    """SDPA with the bias as a float attn_mask (bf16, as SDPA takes it with
    bf16 q), enable_gqa: (forward ms, backward ms as fwd + bwd minus fwd,
    the mask's gradient included). Its own yardstick, used nowhere in the
    port."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    mask = bias.detach().to(torch.bfloat16).requires_grad_()
    gqa = True

    def fwd():
        if gqa:
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qg, kr, vr, attn_mask=mask)
    try:
        fwd()
    except RuntimeError as exc:  # no backend with GQA and a float mask
        print(f"  SDPA with enable_gqa and a float mask: {exc}; k and v "
              "repeated to every query head first", flush=True)
        g = q.shape[1] // k.shape[1]
        kr, vr = (t.detach().repeat_interleave(g, 1).requires_grad_()
                  for t in (k, v))
        kg, vg, gqa = kr, vr, False
    with torch.no_grad():
        only = time_ms([fwd], iters=5, warmup=1)
    both = time_ms([lambda: torch.autograd.grad(fwd(), (qg, kg, vg, mask),
                                                do)], iters=5, warmup=1)
    return only, both - only


def bias_case(gen, label, shape, kind):
    """Phase 14, one case: `flash_attention(q, k, v, bias, causal=True)`
    forward and backward with bias.requires_grad through the autograd
    function (the main path: exact launches of the bias instantiations and
    the dbias kernel, no plain version); out, dq, dk, dv and dbias within
    twice the bf16 plain version's error against the fp32 plain version; a
    second pass bitwise equal; the backward's peak memory beside the bias's
    size; then each kernel timed alone against the plain version, SDPA
    with the bias as a float mask and its bound (the bias bytes it reads
    and the dbias it writes). Returns the kernel rows, with this run's
    launches."""
    from xhy_flash_attention_tpu_torch import flash_attention
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = _dims(shape)
    q, k, v, do = _sparse_inputs(gen, shape)
    bias = torch.randn(bias_shape(kind, b, h, s), generator=gen,
                       device="cuda")
    bias_bytes = bias.numel() * bias.element_size()

    def run():
        ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = flash_attention(*ins, causal=True)
        return (out.detach(),) + torch.autograd.grad(out, ins, do)

    torch.cuda.synchronize()
    reset_counts()
    with count_plain_calls() as plain:
        got = run()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**{key: 0 for key in counters()},
            "flash_fwd (flash_attention_fwd)": 1, "flash_bwd_prep": 1,
            "flash_bwd_dkv": 1, "flash_bwd_dq": 1, "flash_bwd_dbias": 1}
    check(counts == want, f"bias {label}: launches {counts} != {want}")
    check(not plain, f"bias {label}: plain versions ran: {plain}")
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"bias {label}: non-finite output or gradient")
    check(got[4].shape == bias.shape and got[4].dtype == bias.dtype,
          f"bias {label}: dbias {tuple(got[4].shape)} {got[4].dtype}")
    ref = plain_bias_attention(q, k, v, do, bias, upcast=True)
    low = plain_bias_attention(q, k, v, do, bias, upcast=False)
    errs = {}
    for what, g, w, lo in zip(("out", "dq", "dk", "dv", "dbias"), got,
                              [ref[0]] + ref[2:], [low[0]] + low[2:]):
        e, e_lp = max_err(g, w), max_err(lo, w)
        errs[what] = (e, e_lp, max_err(g, lo))
        check(e <= 2 * e_lp + (1e-4 if what == "out" else 1e-3),
              f"bias {label} {what}: err vs fp32 plain {e} > 2 x bf16 plain "
              f"{e_lp}")
    del ref, low
    again = run()
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"bias {label}: a second pass is not bitwise equal")
    del again
    # the backward's peak memory above what it returns and its pre-pass
    # keeps (q_s, delta)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(q, k, v, bias, need_lse=True, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, bias, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = sum(t.numel() * t.element_size() for t in (*grads, q, lse))
    extra = peak - kept
    check(extra <= 32 << 20,
          f"bias {label}: the backward's peak {peak} leaves {extra} bytes "
          f"beyond its outputs (dbias, of the bias's {bias_bytes}, "
          "included) and q_s / delta")
    del grads
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    bkw = dict(kw, bias=bias)
    runs = {
        "flash_fwd": lambda: fwd.flash_attention_fwd(q, k, v, bias,
                                                     need_lse=True, **kw),
        "flash_bwd_dkv": lambda: bwd.flash_bwd_dkv(qs, k, v, do, lse, delta,
                                                   dq, dk, dv, **bkw),
        "flash_bwd_dq": lambda: bwd.flash_bwd_dq(qs, k, v, do, lse, delta,
                                                 dq, dk, dv, **bkw),
        "flash_bwd_dbias": lambda: bwd.flash_bwd_dbias(
            qs, k, v, do, lse, delta, bias, causal=True, softcap=0.0)}
    ms = {name: time_ms([fn], iters=10) for name, fn in runs.items()}
    plain_fwd = time_ms([lambda: fwd.attention_fwd_ref(
        q, k, v, need_lse=True, bias=bias, **kw)], iters=2, warmup=1)
    plain_bwd = time_ms([lambda: bwd.attention_bwd_ref(
        q, k, v, out, lse, do, bias=bias, **kw)], iters=2, warmup=1)
    lib_fwd, lib_bwd = _sdpa_bias_ms(q, k, v, do, bias)
    pair = 2.0 * b * h * s * s * d / 2  # one causal s x s x d product
    io = 2.0 * b * s * d * (2 * h + 2 * hk)  # q, do, k, v (bf16)
    stats = 2 * 4.0 * b * h * s  # lse, delta (fp32)
    seen = bias_bytes * (s + 1) / (2 * s)  # the causal part of the bias
    work = {"flash_fwd": (2, 2.0 * b * s * d * (2 * h + 2 * hk)
                          + 4.0 * b * h * s + seen),
            "flash_bwd_dkv": (4, io + stats + 4.0 * b * s * hk * d + seen),
            "flash_bwd_dq": (3, io + stats + 2.0 * b * s * h * d + seen),
            "flash_bwd_dbias": (2, io + stats + seen + bias_bytes)}
    errors = {"flash_fwd": errs["out"][2], "flash_bwd_dkv": max(
        errs["dk"][2], errs["dv"][2]), "flash_bwd_dq": errs["dq"][2],
        "flash_bwd_dbias": errs["dbias"][2]}
    rows = []
    for name, src, where in BIAS_ROWS:
        n_mm, nbytes = work[name]
        bms, by = bound(n_mm * pair, PEAK_BF16_FLOPS, nbytes)
        row = dict(
            name=f"{name} (bias {label})", route="cuda",
            source=f"xhy_flash_attention_tpu_torch/csrc/{src}",
            replaces=f"xhy_flash_attention_tpu/ops/flash_attention/{where}",
            kernel=name, launches=counts[
                "flash_fwd (flash_attention_fwd)" if name == "flash_fwd"
                else name],
            max_abs_err=errors[name], ms=ms[name],
            plain_ms=plain_fwd if name == "flash_fwd" else plain_bwd,
            bound_ms=bms, bound_by=by,
            library_ms=lib_fwd if name == "flash_fwd" else lib_bwd)
        report(row, f"max_abs_err against the bf16 plain version; b{b} h{h} "
                    f"hk{hk} s{s} d{d} causal, bias {tuple(bias.shape)} fp32 "
                    f"({bias_bytes / 1e9:.4g} GB, {seen / 1e9:.4g} GB of it "
                    f"causal), {n_mm} products, bytes {nbytes:.4g}; "
                    + ("plain_ms: the plain forward; library_ms: SDPA with "
                       "the bias as a float mask" if name == "flash_fwd" else
                       "plain_ms: the plain backward, library_ms: SDPA's "
                       "backward with the mask's gradient, both whole"))
        rows.append(row)
    whole = ms["flash_bwd_dkv"] + ms["flash_bwd_dq"] + ms["flash_bwd_dbias"]
    print(f"  bias {label}: b{b} h{h} hk{hk} s{s} d{d} causal, bias "
          f"{tuple(bias.shape)}; "
          + ", ".join(f"{w} err {e:.3g} (bf16 plain {e_lp:.3g})"
                      for w, (e, e_lp, _) in errs.items())
          + f"; second pass bitwise equal; forward {ms['flash_fwd']:.4f} ms "
          f"(SDPA {lib_fwd:.4f}); backward kernels dK/dV + dQ + dbias "
          f"{whole:.4f} ms (SDPA's backward {lib_bwd:.4f}); the backward's "
          f"peak {peak / 1e6:.1f} MB: its outputs dq, dk, dv and dbias (the "
          f"bias's {bias_bytes / 1e6:.1f} MB), q_s and delta, and "
          f"{extra / 1e6:.1f} MB more", flush=True)
    return rows


def bridge_on_card(gen):
    """Phase 14's end: `capi_bridge.attn_fwd` and `attn_bwd` with an
    attn_mask (b, 1, s, s) on numpy bf16 arrays (raw uint16) on the card,
    against the plain versions on the same inputs; launches exact."""
    import numpy as np
    from xhy_flash_attention_tpu_torch import capi_bridge
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = 2, 8, 2, 1024, 128
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in _sparse_inputs(
        gen, dict(b=b, h=h, hk=hk, s=s, d=d)))  # (b, s, h, d)
    mask = torch.randn(b, 1, s, s, generator=gen, device="cuda")
    raw = lambda t: t.cpu().view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).view(np.uint16).view(np.int16)).view(
        torch.bfloat16).cuda()
    reset_counts()
    out, lse = capi_bridge.attn_fwd(raw(q), raw(k), raw(v), mask.cpu().numpy(),
                                    None, 0.0, 0, 0.0, 1, -1, -1, 0.0)
    dq, dk, dv, dbias = capi_bridge.attn_bwd(
        raw(do), raw(q), raw(k), raw(v), out, lse, mask.cpu().numpy(), None,
        0.0, 0, 0.0, 1, -1, -1, 0.0)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**{key: 0 for key in counters()},
            "flash_fwd (flash_attention_fwd)": 1, "flash_bwd_prep": 1,
            "flash_bwd_dkv": 1, "flash_bwd_dq": 1, "flash_bwd_dbias": 1}
    check(counts == want, f"capi_bridge: launches {counts} != {want}")
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0, bias=mask)
    ref, ref_lse = fwd.attention_fwd_ref(qt, kt, vt, need_lse=True, **kw)
    out_t = back(out).transpose(1, 2)
    lse_t = torch.from_numpy(lse).cuda()
    want_g = bwd.attention_bwd_ref(qt, kt, vt, out_t, lse_t, dot, **kw)
    e_out = max_err(out_t, ref)
    tol_out = BF16_ULP * ref.float().abs().max().item() + 1e-3
    check(e_out <= tol_out and max_err(lse_t, ref_lse) <= 1e-3,
          f"capi_bridge attn_fwd: out err {e_out} > {tol_out} or lse")
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want_g[:3]):
        e, tol = max_err(back(g).transpose(1, 2), w), \
            4 * BF16_ULP * w.float().abs().max().item() + 1e-4
        check(e <= tol, f"capi_bridge attn_bwd {name}: err {e} > {tol}")
        errs.append(e)
    e_db = max_err(torch.from_numpy(dbias).cuda(), want_g[3])
    tol_db = 1e-3 * want_g[3].abs().max().item() + 1e-4
    check(dbias.shape == (b, 1, s, s) and e_db <= tol_db,
          f"capi_bridge attn_bwd dbias {dbias.shape}: err {e_db} > {tol_db}")
    print(f"  capi_bridge on the card: attn_fwd + attn_bwd with an attn_mask "
          f"(b{b} h{h} hk{hk} s{s} d{d} causal, mask {tuple(mask.shape)} "
          f"fp32, numpy bf16 as raw uint16): out err {e_out:.3g} (tol "
          f"{tol_out:.3g}), dq/dk/dv err {max(errs):.3g}, dbias err "
          f"{e_db:.3g} (tol {tol_db:.3g}) against the plain versions; "
          f"launches {json.dumps({k_: v_ for k_, v_ in counts.items() if v_})}",
          flush=True)


def bias_entries(gen):
    """Phase 14: every bias case, then the C-API bridge. Returns the rows."""
    rows = []
    for label, shape, kind in BIAS_CASES:
        rows += bias_case(gen, label, shape, kind)
        torch.cuda.empty_cache()
    bridge_on_card(gen)
    return rows


# ------------------------------------------------- phase 8: the training slice

CONFIGS = "xhy_flash_attention_tpu/training/configs/experiment"
RECIPES = {  # name -> (config, the attention kernels on its path)
    "T-long": (f"{CONFIGS}/pile/gpt3m-flash.yaml",
               ("flash_fwd (flash_attention_fwd)", "flash_bwd_prep",
                "flash_bwd_dkv", "flash_bwd_dq")),
    "T-packed": (f"{CONFIGS}/owt/gpt2m-flash.yaml",
                 ("flash_fwd (fused_heads)", "flash_bwd_prep",
                  "fused_heads_bwd")),
}
TRAIN_STEPS = 6
# Batch halvings a recipe needs to fit the card's 80 GB with the simple
# kernels (none: both recipes run at the published batch).
BATCH_CUT = {}


def write_tokens(path, seed, n_tokens, vocab=50257):
    import numpy as np
    rng = np.random.default_rng(seed)
    rng.integers(0, vocab, n_tokens).astype(np.uint16).tofile(path)


@contextlib.contextmanager
def count_plain_calls():
    """Count every call of a plain version that the kernel wrappers (or
    their autograd functions) could make; yields the dict of counts."""
    mods = {m: importlib.import_module(_PKG + m) for m in (
        "layer_norm", "flash_attention.fwd", "flash_attention.bwd",
        "flash_attention.fused_heads")}
    names = ("ln_fwd_ref", "ln_bwd_ref", "attention_fwd_ref",
             "attention_bwd_ref", "bwd_prep_ref", "fused_heads_fwd_ref",
             "fused_heads_bwd_ref", "attention_fp8_ref")
    calls, saved = {}, []
    for mod in mods.values():
        for name in names:
            if hasattr(mod, name):
                fn = getattr(mod, name)
                saved.append((mod, name, fn))

                def spy(*a, _fn=fn, _name=name, **k):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*a, **k)
                setattr(mod, name, spy)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# Readings on one H100 at 700 W (PERF.md section 5), printed beside this
# run's: the median step of phase 8, its MFU, and phase 10's "attention
# fwd" group while the dense forward was the earlier mma.sync kernel, and
# the step, MFU and "attention bwd" group while the dense backward was
MMA_SYNC_TRAINING = {
    "T-long": dict(step_ms=451.0, mfu=0.178, attention_fwd_ms=35.4),
    "T-packed": dict(step_ms=303.4, mfu=0.248, attention_fwd_ms=19.6)}
MMA_SYNC_BWD_TRAINING = {
    "T-long": dict(step_ms=421.4, mfu=0.1905, attention_bwd_ms=126.0),
    "T-packed": dict(step_ms=287.7, mfu=0.2617, attention_bwd_ms=68.8)}


def train_recipe(name, seed, tmp, recipe=None, extra=None,
                 steps=TRAIN_STEPS):
    """Phase 8 for one recipe (``recipe`` (config, kernels), RECIPES[name]
    by default; ``extra`` overrides, such as a dtype): ``train(config,
    **overrides)`` for ``steps`` steps; each step's launches checked
    exactly in the log callback. Returns (trainer, summary)."""
    from xhy_flash_attention_tpu_torch.training import load_config, train
    from xhy_flash_attention_tpu_torch.training.callbacks import (
        gpt_flops_per_token)
    path, path_kernels = recipe or RECIPES[name]
    cfg = load_config(path)
    batch = cfg.data.batch_size // 2 ** BATCH_CUT.get(name, 0)
    seqlen, layers = cfg.data.seqlen, cfg.model["num_hidden_layers"]
    tokens = os.path.join(tmp, f"{name}.bin")
    write_tokens(tokens, seed, batch * (seqlen + 1) * (steps + 2))
    overrides = {"data.path": tokens, "data.batch_size": batch,
                 "max_steps": steps, "log_every": 1, "ckpt_every": 0,
                 "ckpt_dir": os.path.join(tmp, f"ckpt-{name}"),
                 **(extra or {})}
    flops_tok = gpt_flops_per_token(
        layers, cfg.model["hidden_size"], seqlen,
        (cfg.model["vocab_size"] + 127) // 128 * 128)
    want = {k: 0 for k in counters()}
    want.update({"rms_norm_add": 2 * layers + 1, "ln_bwd": 2 * layers + 1,
                 **{k: layers for k in path_kernels}})
    records, launches = [], {k: 0 for k in counters()}
    print(f"  {name}: {path}, hidden {cfg.model['hidden_size']}, {layers} "
          f"layers, {cfg.model['num_attention_heads']} heads, seqlen "
          f"{seqlen}, batch {batch}"
          + (f" (published {cfg.data.batch_size}, halved "
             f"{BATCH_CUT[name]}x to fit)" if name in BATCH_CUT else
             " (as published)")
          + f", {steps} steps, the recipe's AdamW and schedule"
          + (f", overrides {extra}" if extra else ""),
          flush=True)

    def log(msg):
        now = time.perf_counter()
        counts = read_counts()
        check(counts == want, f"{name} step {len(records) + 1}: launches "
                              f"{counts} != {want}")
        for k, v in counts.items():
            launches[k] += v
        reset_counts()
        records.append((now, msg))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        trainer = train(path, **overrides, log=log)
    peak = torch.cuda.max_memory_allocated()
    check(not plain, f"{name}: plain versions ran on the main path: {plain}")
    check(len(records) == steps, f"{name}: {len(records)} steps logged")
    hist = trainer.history
    tok = batch * seqlen
    prev = t0
    step_ms = []
    for h, (stamp, _) in zip(hist, records):
        ms = (stamp - prev) * 1e3
        prev = stamp
        step_ms.append(ms)
        mfu = flops_tok * tok / (ms / 1e3) / PEAK_BF16_FLOPS
        print(f"    step {h['step']}: loss {h['loss']:.4f}, grad norm "
              f"{h['grad_norm']:.4f}, step ms {ms:.2f}"
              + (" (includes building the model and the first step's "
                 "set-up)" if h["step"] == 1 else "")
              + f", tokens/s {tok / (ms / 1e3):.1f}, MFU {mfu:.4f}",
              flush=True)
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    check(abs(losses[0] - math.log(50257)) <= 0.5,
          f"{name}: first loss {losses[0]} not within 0.5 of ln(50257)")
    for pname, p in trainer.model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{name}: parameter {pname} has no finite gradient")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    summary = dict(
        recipe=name, batch=batch, seqlen=seqlen, layers=layers,
        step_ms_median_of_2_on=steady, tokens_per_s=tok / (steady / 1e3),
        mfu=flops_tok * tok / (steady / 1e3) / PEAK_BF16_FLOPS,
        flops_per_token=flops_tok, peak_memory_gib=peak / 2 ** 30,
        losses=losses, launches={k: v for k, v in launches.items() if v})
    print(f"  {name} summary: {json.dumps(summary)}", flush=True)
    if name not in MMA_SYNC_TRAINING:
        return trainer, summary
    before, bwd_before = MMA_SYNC_TRAINING[name], MMA_SYNC_BWD_TRAINING[name]
    print(f"  {name}: step ms {steady:.1f} (mma.sync forward: "
          f"{before['step_ms']}; mma.sync backward: "
          f"{bwd_before['step_ms']}), MFU {summary['mfu']:.4f} (mma.sync "
          f"forward: {before['mfu']}; mma.sync backward: "
          f"{bwd_before['mfu']})", flush=True)
    return trainer, summary


# ------------------------------------- phase 9: kernels vs plain, one step

# Readings on an H100 (depth 2, one step at full width and batch, token
# files from seeds 0 and 1): |loss kernels - loss plain| 3.81e-6 and
# 2.48e-5 (T-long), 0 and 3.81e-5 (T-packed); the largest gradient
# difference over all parameters, relative to that gradient's largest
# entry, 0.007752 / 0.01056 (T-long) and 0.007853 / 0.007692 (T-packed),
# median 0.0051-0.0057: bf16 rounding at other places in two paths. The
# limits are about 2x the largest readings.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.02


def train_vs_plain(name, seed, tmp):
    """One step's loss and gradients at depth 2, full width and batch,
    through the kernels and through the plain versions, same parameters
    and batch."""
    from xhy_flash_attention_tpu_torch.training import Trainer, load_config
    path, _ = RECIPES[name]
    cfg = load_config(path)
    batch = cfg.data.batch_size // 2 ** BATCH_CUT.get(name, 0)
    tokens = os.path.join(tmp, f"{name}-depth2.bin")
    write_tokens(tokens, seed + 1, batch * (cfg.data.seqlen + 1) * 2)
    cfg = load_config(path, {"data.path": tokens, "data.batch_size": batch,
                             "model.num_hidden_layers": 2})
    trainer = Trainer(cfg)
    trainer.init_params()
    ids, labels = trainer._batch(*next(iter(trainer.data)))
    reset_counts()
    loss_k, grads_k = trainer.compute_grads(ids, labels)
    kern_counts = read_counts()
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    reset_counts()
    with plain_versions():
        loss_p, grads_p = trainer.compute_grads(ids, labels)
    check(all(v == 0 for v in read_counts().values()),
          f"the plain step launched a kernel: {read_counts()}")
    check(all(kern_counts[k] > 0 for k in RECIPES[name][1]),
          f"{name}: the kernel step missed a kernel: {kern_counts}")
    dl = abs(float(loss_k) - float(loss_p))
    rel = {n: max_err(grads_k[n], grads_p[n])
           / max(grads_p[n].abs().max().item(), 1e-30) for n in grads_p}
    worst = max(rel, key=rel.get)
    print(f"  {name} depth 2, batch {batch}: loss kernels {float(loss_k):.5f}"
          f" plain {float(loss_p):.5f} (|diff| {dl:.3g}, tol "
          f"{TRAIN_LOSS_TOL}); gradients, max |diff| / max |plain| over "
          f"{len(rel)} parameters: largest {rel[worst]:.4g} ({worst}), "
          f"median {sorted(rel.values())[len(rel) // 2]:.4g} (tol "
          f"{TRAIN_GRAD_TOL})", flush=True)
    check(dl <= TRAIN_LOSS_TOL, f"{name}: loss differs by {dl}")
    check(rel[worst] <= TRAIN_GRAD_TOL,
          f"{name}: gradient of {worst} differs by {rel[worst]}")
    return dict(loss_diff=dl, grad_rel_max=rel[worst], worst=worst)


# -------------------------------------------- phase 10: where the time goes

TRAIN_GROUPS = {"flash_fwd": "attention fwd", "attention bwd": "attention bwd",
                "rms_norm_add": "norm fwd", "norm bwd": "norm bwd",
                "matmul": "matmul"}


def train_breakdown(trainer, name):
    """Two more training steps of ``trainer``, each in a torch.profiler
    window (host and device activity): the first window holds the
    profiler's own start-up and is discarded; of the second, device ms by
    group and the idle share. Kernels launched inside the loss's profiler
    range count as cross-entropy; the device-side copies of host ranges are
    not device work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xhy_flash_attention_tpu_torch.losses.cross_entropy import \
        PROFILE_RANGE
    it = iter(trainer.data)
    for _ in range(2):
        batch = trainer._batch(*next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(*batch)
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host_ranges = {e.name for e in events if e.device_type == DeviceType.CPU}
    groups = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in host_ranges:
            g = TRAIN_GROUPS.get(_group(e.name), "other")
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3

    def in_loss(e):
        while e is not None:
            if PROFILE_RANGE in e.name:
                return True
            e = e.cpu_parent
        return False
    ce_ms = sum(k.duration for e in events
                if e.device_type == DeviceType.CPU and e.kernels
                and in_loss(e) for k in e.kernels) / 1e3
    if ce_ms > 0:
        groups["cross-entropy"] = ce_ms
        groups["other"] = groups.get("other", 0.0) - ce_ms
    busy = sum(groups.values())
    out = {"recipe": name, "wall_ms_profiled": wall_ms,
           "device_ms": {g: v for g, v in sorted(groups.items(),
                                                 key=lambda kv: -kv[1])},
           "device_busy_ms": busy,
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "cross_entropy": ("from the xfa::cross_entropy range" if ce_ms > 0
                             else "not measured (no kernels under the "
                                  "range); inside other")}
    print(f"  training step breakdown: {json.dumps(out)}", flush=True)
    if name in MMA_SYNC_TRAINING:
        print(f"  {name}: attention fwd {groups.get('attention fwd', 0.0):.1f}"
              f" ms of the step (mma.sync forward: "
              f"{MMA_SYNC_TRAINING[name]['attention_fwd_ms']}), attention bwd"
              f" {groups.get('attention bwd', 0.0):.1f} ms (mma.sync "
              f"backward: {MMA_SYNC_BWD_TRAINING[name]['attention_bwd_ms']})",
              flush=True)
    check(busy > 0, f"{name}: the profiler saw no device time")
    return out


# ------------------------------------------------ phase 15: the fp8 prefill

PEAK_FP8_FLOPS = 1979e12   # H100 SXM dense fp8 tensor-core rate
# label: ((b, h, hk, sq, sk, d), flash_attn_fp8_func keywords); the timed
# cases: request A's prefill attention at Llama-3-8B width, its 8k-token
# prompt, T-long's attention (d 64)
FP8_CASES = {
    "FP8-A": ((2, 32, 8, 2048, 2048, 128), dict(causal=True)),
    "FP8-8k": ((1, 32, 8, 8192, 8192, 128), dict(causal=True)),
    "FP8-d64": ((16, 16, 16, 2048, 2048, 64), dict(causal=True)),
}
# correctness only: a window and softcap at FP8-8k's width, odd lengths
FP8_CHECKS = {
    "FP8-8k window (4095, 0)": ((1, 32, 8, 8192, 8192, 128),
                                dict(window_size=(4095, 0))),
    "FP8-8k softcap 30": ((1, 32, 8, 8192, 8192, 128),
                          dict(causal=True, softcap=30.0)),
    "odd 113/203": ((2, 32, 8, 113, 203, 128), dict(causal=True)),
    "odd 257": ((2, 16, 16, 257, 257, 64), dict(causal=False)),
}


def fp8_inputs(gen, b, h, hk, sq, sk, d):
    """q/k/v (b, s, ·, d) drawn on the card with per-head magnitudes
    spanning ~30x (the JAX test's: uniform scales would hide descale
    faults), quantized by quantize_fp8_per_head: (q8, k8, v8, qd, kd,
    vd)."""
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


def _fp8_dequant(x8, dsc):
    """An e4m3 slice (b, s, heads of kv-head groups, d) times its
    descales (b, groups) as fp32."""
    b, s, h, d = x8.shape
    g = dsc.shape[1]
    return (x8.float().view(b, s, g, h // g, d)
            * dsc[:, None, :, None, None]).view(b, s, h, d)


def _window_keep(sq, sk, causal=False, window_size=(-1, -1), **unused):
    left, right = window_size
    if causal:
        right = 0
    rows = torch.arange(sq, device="cuda")[:, None] + sk - sq
    cols = torch.arange(sk, device="cuda")[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if right >= 0:
        keep &= cols <= rows + right
    if left >= 0:
        keep &= cols >= rows - left
    return keep


def fp8_plain(x, kw, upcast):
    """The contract's references on the dequantized inputs, kv-head groups
    at a time (PLAIN_CHUNK_BYTES): ``attention_ref`` in fp32 (``upcast``)
    or the bf16 reorder-ops baseline, and the LSE of the scores in fp32 or
    from bf16 inputs. Returns (out (b, sq, h, d), lse (b, h, sq))."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_ref
    q8, k8, v8, qd, kd, vd = x
    b, sq, h, d = q8.shape
    sk, hk = k8.shape[1], k8.shape[2]
    g = h // hk
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    keep = _window_keep(sq, sk, **kw)
    outs, lses = [], []
    for j in range(0, hk, step):
        ks = slice(j, min(j + step, hk))
        qf = _fp8_dequant(q8[:, :, j * g: ks.stop * g], qd[:, ks])
        kf = _fp8_dequant(k8[:, :, ks], kd[:, ks])
        vf = _fp8_dequant(v8[:, :, ks], vd[:, ks])
        if not upcast:
            qf, kf, vf = qf.bfloat16(), kf.bfloat16(), vf.bfloat16()
        o, _ = attention_ref(qf, kf, vf, upcast=upcast,
                             reorder_ops=not upcast, **kw)
        sc = torch.einsum("bshd,bthd->bhst", qf.float(),
                          kf.float().repeat_interleave(g, dim=2)) * d ** -0.5
        if kw.get("softcap", 0.0) > 0:
            sc = torch.tanh(sc / kw["softcap"]) * kw["softcap"]
        lses.append(torch.logsumexp(sc.masked_fill(~keep, -math.inf), -1))
        outs.append(o)
        del sc
    return torch.cat(outs, 2), torch.cat(lses, 1)


def fp8_plain_version(x, kw):
    """The kernel's plain version (reference.attention_fp8_ref) on the card,
    kv-head groups at a time: (out (b, sq, h, d), lse, ms)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_fp8_ref
    q8, k8, v8, qd, kd, vd = x
    b, sq, h, d = q8.shape
    sk, hk = k8.shape[1], k8.shape[2]
    g = h // hk
    step = max(1, int(PLAIN_CHUNK_BYTES // (b * g * sq * sk * 4)))
    outs, lses, ms = [], [], 0.0
    for j in range(0, hk, step):
        ks = slice(j, min(j + step, hk))
        args = (q8[:, :, j * g: ks.stop * g].transpose(1, 2),
                k8[:, :, ks].transpose(1, 2), v8[:, :, ks].transpose(1, 2),
                qd[:, ks], kd[:, ks], vd[:, ks])
        call = (lambda: attention_fp8_ref(*args, sm_scale=d ** -0.5, **kw))
        o, lse = call()
        ms += time_ms([call], iters=2, warmup=0)
        outs.append(o.transpose(1, 2))
        lses.append(lse)
    return torch.cat(outs, 2), torch.cat(lses, 1), ms


def visible_count(b, h, sq, sk, kw):
    return b * h * int(_window_keep(sq, sk, **kw).sum().item())


def fp8_case(gen, label, shape, kw, timed):
    """Phase 15, one case through `flash_attn_fp8_func` (the main path):
    exact launches (the e4m3 instantiation once, no plain version), out and
    LSE within twice the bf16 plain version's error against the fp32 plain
    version on the dequantized inputs (the JAX fp8 test's contract: atol
    1e-4 and 1e-3), out and LSE against the kernel's own plain version
    (attention_fp8_ref) within the limits on the e4m3 wgmma's accumulation
    error (reference.fp8_ref_errors: the sums of e4m3 products carry fewer
    mantissa bits than fp32, so a score is off by a fraction of its
    products' magnitude, the LSE by as much and the output by about as
    much times the KV head's largest |v|; reference.FP8_OUT_TOL and
    FP8_LSE_TOL), a second call bitwise equal; ``timed``: the
    kernel's ms beside its bound, the plain version's, SDPA's in bf16 on
    the dequantized inputs and the port's own bf16 #1 on the same. Returns
    a kernel row with this run's launches, or None."""
    from xhy_flash_attention_tpu_torch import flash_attn_fp8_func
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    from xhy_flash_attention_tpu_torch.ops.flash_attention import reference
    b, h, hk, sq, sk, d = shape
    x = fp8_inputs(gen, b, h, hk, sq, sk, d)
    run = lambda: flash_attn_fp8_func(*x, return_lse=True, **kw)  # noqa: E731
    torch.cuda.synchronize()
    reset_counts()
    with count_plain_calls() as plain:
        out, lse = run()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**{key: 0 for key in counters()}, "flash_fwd_fp8": 1}
    check(counts == want, f"fp8 {label}: launches {counts} != {want}")
    check(not plain, f"fp8 {label}: plain versions ran: {plain}")
    check(out.dtype == torch.bfloat16 and out.shape == (b, sq, h, d)
          and lse.shape == (b, h, sq), f"fp8 {label}: out {out.dtype} "
          f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
    ref, ref_lse = fp8_plain(x, kw, True)
    low, low_lse = fp8_plain(x, kw, False)
    fin = torch.isfinite(ref_lse)
    check(torch.equal(fin, torch.isfinite(lse)), f"fp8 {label}: the rows "
          "that see no key differ")
    e, e_lp = max_err(out, ref), max_err(low, ref)
    el, el_lp = (max_err(lse[fin], ref_lse[fin]),
                 max_err(low_lse[fin], ref_lse[fin]))
    check(e <= 2 * e_lp + 1e-4, f"fp8 {label} out: err {e} > 2 x {e_lp}")
    check(el <= 2 * el_lp + 1e-3, f"fp8 {label} lse: err {el} > 2 x {el_lp}")
    del ref, low, ref_lse, low_lse
    again = run()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"fp8 {label}: a second call is not bitwise equal")
    del again
    plain_out, plain_lse, plain_ms = fp8_plain_version(x, kw)
    err_plain = max_err(out, plain_out)
    eo, el_acc = reference.fp8_ref_errors(out, lse, plain_out, plain_lse, x[0],
                                          x[1], x[3], x[4], x[5], d ** -0.5)
    del plain_out, plain_lse
    lim_out, lim_lse = reference.FP8_OUT_TOL, reference.FP8_LSE_TOL
    check(eo <= lim_out and el_acc <= lim_lse,
          f"fp8 {label} against its plain version: out {eo:.4g} (limit "
          f"{lim_out}), lse {el_acc:.4g} (limit {lim_lse}) of the "
          "accumulation scale")
    print(f"  fp8 {label}: b{b} h{h} hk{hk} sq{sq} sk{sk} d{d} {kw}: out "
          f"err {e:.4g} (bf16 plain {e_lp:.4g}), lse err {el:.4g} (bf16 "
          f"plain {el_lp:.4g}) against the fp32 plain version; against the "
          f"kernel's plain version: max |out err| {err_plain:.4g}; in units "
          f"of the accumulation scale out {eo:.4g} (limit {lim_out}), "
          f"lse {el_acc:.4g} (limit {lim_lse}); launches "
          f"{counts['flash_fwd_fp8']}, no plain "
          "version; a second call bitwise equal", flush=True)
    if not timed:
        return None
    ms = time_ms([run], iters=20)
    q8, k8, v8, qd, kd, vd = x
    g = h // hk
    qb = _fp8_dequant(q8, qd).bfloat16()
    kb = _fp8_dequant(k8, kd).bfloat16()
    vb = _fp8_dequant(v8, vd).bfloat16()
    qt, kt, vt = (t.transpose(1, 2) for t in (qb, kb, vb))
    bf16_ms = time_ms([lambda: fwd.flash_attention_fwd(
        qt, kt, vt, sm_scale=d ** -0.5, causal=kw["causal"],
        need_lse=True)], iters=20)
    kr, vr = (t.repeat_interleave(g, 1) for t in (kt, vt))
    sdpa_ms = time_ms([lambda: F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=kw["causal"])], iters=20)
    del qb, kb, vb, qt, kt, vt, kr, vr
    pairs = visible_count(b, h, sq, sk, kw)
    flops = 2.0 * d * pairs  # each of QK^T and P.V
    t_ops = (flops / PEAK_FP8_FLOPS + flops / PEAK_BF16_FLOPS) * 1e3
    nbytes = b * d * (sq * h + 2 * sk * hk) + 2.0 * b * sq * h * d \
        + 4.0 * b * h * sq
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                              "bytes")
    row = dict(
        name=f"flash_fwd_fp8 ({label})", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78 "
                 "_fwd_kernel (fp8)",
        kernel="flash_fwd_fp8", launches=counts["flash_fwd_fp8"],
        max_abs_err=err_plain, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=sdpa_ms)
    report(row, f"max_abs_err against the plain version; {pairs} visible "
                f"pairs, QK^T {flops:.4g} FLOP at 1979e12 and P.V at 989e12, "
                f"{nbytes:.4g} bytes; library_ms: SDPA in bf16 on the "
                "dequantized inputs (k, v repeated to the query heads); "
                f"the port's bf16 #1 on the same {bf16_ms:.4f} ms")
    row["bf16_ms"] = bf16_ms
    return row


def fp8_prefill(gen):
    """Phase 15: the timed cases, then the correctness-only ones. Returns
    the timed cases' kernel rows."""
    rows = [fp8_case(gen, label, shape, kw, True)
            for label, (shape, kw) in FP8_CASES.items()]
    torch.cuda.empty_cache()
    for label, (shape, kw) in FP8_CHECKS.items():
        fp8_case(gen, label, shape, kw, False)
        torch.cuda.empty_cache()
    return rows


# ----------------------------------- phase 16: T-8k training with remat

REMAT_RECIPE = f"{CONFIGS}/pile/gpt3m-flash-8k.yaml"
REMAT_RUNS = (  # label, overrides, steps
    ("save_attn", {}, TRAIN_STEPS),
    ("save_dots", {"model.remat_policy": "save_dots"}, 2),
    ("nothing", {"model.remat_policy": "nothing"}, 2),
    ("no remat", {"model.remat": False}, 2))
# depth 2: remat against no remat, same parameters and batch: the same
# kernels on the same inputs; a bound for what other choices of cuBLAS
# algorithms between the two runs could move (read: bitwise equal)
REMAT_LOSS_TOL = 1e-5
REMAT_GRAD_TOL = 1e-3


def train_remat_run(label, over, steps, seed, tmp):
    """``train(gpt3m-flash-8k.yaml)`` at full width, depth and batch for
    ``steps`` steps with ``over``: exact launches per step (the attention
    forward once a layer under save_attn and without remat, twice under
    "nothing"; the norm's forward again in every recomputed block), no
    plain version. Returns its summary."""
    from xhy_flash_attention_tpu_torch.training import load_config, train
    from xhy_flash_attention_tpu_torch.training.callbacks import (
        gpt_flops_per_token)
    cfg = load_config(REMAT_RECIPE, over)
    m = cfg.model
    batch, seqlen, layers = cfg.data.batch_size, cfg.data.seqlen, \
        m["num_hidden_layers"]
    remat, policy = m.get("remat", False), m.get("remat_policy", "save_attn")
    tokens = os.path.join(tmp, "t8k.bin")
    if not os.path.exists(tokens):
        write_tokens(tokens, seed, batch * (seqlen + 1) * (TRAIN_STEPS + 2))
    overrides = {**over, "data.path": tokens, "max_steps": steps,
                 "log_every": 1, "ckpt_every": 0,
                 "ckpt_dir": os.path.join(tmp, f"ckpt-{label}")}
    flops_tok = gpt_flops_per_token(layers, m["hidden_size"], seqlen,
                                    (m["vocab_size"] + 127) // 128 * 128)
    want = {k: 0 for k in counters()}
    want.update({
        "rms_norm_add": 2 * layers + 1 + (2 * layers if remat else 0),
        "ln_bwd": 2 * layers + 1, "flash_bwd_prep": layers,
        "flash_bwd_dkv": layers, "flash_bwd_dq": layers,
        "flash_fwd (flash_attention_fwd)": layers * (
            2 if remat and policy == "nothing" else 1)})
    stamps = []

    def log(msg):
        counts = read_counts()
        check(counts == want, f"T-8k {label} step {len(stamps) + 1}: "
                              f"launches {counts} != {want}")
        reset_counts()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    gc.collect()  # earlier phases' garbage would count in the peak
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        trainer = train(REMAT_RECIPE, **overrides, log=log)
    peak = torch.cuda.max_memory_allocated()
    check(not plain, f"T-8k {label}: plain versions ran: {plain}")
    check(len(stamps) == steps, f"T-8k {label}: {len(stamps)} steps logged")
    check(trainer.model_cfg.remat == remat
          and trainer.model_cfg.remat_policy == policy,
          f"T-8k {label}: the model took remat {trainer.model_cfg.remat} "
          f"{trainer.model_cfg.remat_policy}")
    losses = [h_["loss"] for h_ in trainer.history]
    check(all(math.isfinite(x) for x in losses), f"T-8k {label}: {losses}")
    step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip([t0] + stamps, stamps)]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tok = batch * seqlen
    out = dict(run=label, remat=remat, policy=policy if remat else None,
               steps=steps, batch=batch, seqlen=seqlen, layers=layers,
               step_ms=step_ms, step_ms_median_after_first=steady,
               tokens_per_s=tok / (steady / 1e3),
               mfu=flops_tok * tok / (steady / 1e3) / PEAK_BF16_FLOPS,
               peak_memory_gib=peak / 2 ** 30,
               allocated_before_gib=base / 2 ** 30, losses=losses,
               launches_per_step={k: v for k, v in want.items() if v})
    print(f"  T-8k {label}: {json.dumps(out)}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def remat_vs_plain(seed, tmp):
    """One step at depth 2, full width, seqlen and batch, with remat
    (save_attn) and without, same parameters (the recipe's seed) and batch:
    the loss and every gradient."""
    from xhy_flash_attention_tpu_torch.training import Trainer, load_config
    tokens = os.path.join(tmp, "t8k.bin")
    grads = {}
    for remat in (True, False):
        cfg = load_config(REMAT_RECIPE, {"data.path": tokens,
                                         "model.num_hidden_layers": 2,
                                         "model.remat": remat})
        trainer = Trainer(cfg)
        trainer.init_params()
        ids, labels = trainer._batch(*next(iter(trainer.data)))
        loss, g = trainer.compute_grads(ids, labels)
        grads[remat] = (float(loss), {n: t.clone() for n, t in g.items()})
        del trainer
    (lr, gr), (lp, gp) = grads[True], grads[False]
    bitwise = lr == lp and all(torch.equal(gr[n], gp[n]) for n in gp)
    rel = {n: max_err(gr[n], gp[n]) / max(gp[n].abs().max().item(), 1e-30)
           for n in gp}
    worst = max(rel, key=rel.get)
    print(f"  T-8k depth 2: loss with remat {lr:.6f}, without {lp:.6f}; "
          f"gradients, max |diff| / max |no remat| over {len(rel)} "
          f"parameters: largest {rel[worst]:.4g} ({worst}); bitwise equal: "
          f"{bitwise} (bounds: loss {REMAT_LOSS_TOL}, gradients "
          f"{REMAT_GRAD_TOL})", flush=True)
    check(abs(lr - lp) <= REMAT_LOSS_TOL, f"T-8k: loss differs {lr} {lp}")
    check(rel[worst] <= REMAT_GRAD_TOL,
          f"T-8k: gradient of {worst} differs by {rel[worst]}")
    return dict(bitwise=bitwise, grad_rel_max=rel[worst])


def train_with_remat(seed):
    """Phase 16: T-8k under its own remat (save_attn), then "save_dots",
    "nothing", and without remat; then the depth-2 check."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = [train_remat_run(label, over, steps, seed, tmp)
                for label, over, steps in REMAT_RUNS]
        remat_vs_plain(seed, tmp)
    by = {r["run"]: r for r in runs}
    check(by["save_attn"]["peak_memory_gib"]
          < by["no remat"]["peak_memory_gib"],
          "T-8k: save_attn's peak memory is not below no remat's")
    print("  T-8k: " + "; ".join(
        f"{r['run']}: step {r['step_ms_median_after_first']:.1f} ms, "
        f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.4f}, peak "
        f"{r['peak_memory_gib']:.2f} GiB" for r in runs), flush=True)
    return runs


# ------------------------- phase 17: weight-only int8 / int4 serving

def weight_bytes(model, quantized_only=False):
    """Bytes of the model's weights, or of its QuantDense payloads alone."""
    from xhy_flash_attention_tpu_torch.modules.linear import QuantDense
    if quantized_only:
        return sum(m.weight_q.numel() * m.weight_q.element_size()
                   for m in model.modules() if isinstance(m, QuantDense))
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def check_quantized(model_q, model_f, wq):
    """Every QuantDense of ``model_q`` holds its float counterpart in
    ``model_f`` to half a quantization step: |dequant - w| <= scale / 2 per
    output channel (fp32 rounding of w / scale aside: 1e-3 of a step), its
    values within [-qmax, qmax]."""
    from xhy_flash_attention_tpu_torch.modules.linear import QuantDense
    from xhy_flash_attention_tpu_torch.ops.quant import dequantize_weight
    qmax = 127 if wq == "int8" else 7
    floats = dict(model_f.named_modules())
    worst, n = 0.0, 0
    with torch.no_grad():
        for name, mod in model_q.named_modules():
            if not isinstance(mod, QuantDense):
                continue
            q = dequantize_weight(mod.weight_q, torch.float32)
            check(int(q.abs().max().item()) <= qmax,
                  f"W{wq[3:]} {name}: a value past {qmax}")
            step = mod.weight_scale[:, None]
            err = (q * step - floats[name].weight.float()).abs() / step
            worst = max(worst, err.max().item())
            n += 1
            del q, err
    print(f"  W{wq[3:]}: {n} quantized projections, each weight within "
          f"{worst:.6f} of a step of its bf16 value (bound 0.5)", flush=True)
    check(worst <= 0.5 + 1e-3, f"W{wq[3:]}: a weight {worst} steps off")


def quant_vs_float(model_q, model_f, gen, wq):
    """The quantized model's prefill logits against the bf16 model's on
    one request-A prompt: largest and rms difference, top-1 agreement
    (printed, not gated: random weights at this width make near-ties
    common)."""
    b, prompt, _ = REQUESTS["A"]
    ids = torch.randint(0, model_f.config.vocab_size, (b, prompt),
                        generator=gen, device="cuda")
    with torch.inference_mode():
        lf, _ = model_f(ids)
        lq, _ = model_q(ids)
        diff = (lq.float() - lf.float())
        agree = (lq.argmax(-1) == lf.argmax(-1)).float().mean().item()
        out = dict(max_abs=diff.abs().max().item(),
                   rms=diff.pow(2).mean().sqrt().item(),
                   max_abs_float_logit=lf.float().abs().max().item(),
                   top1_agreement=agree)
    print(f"  W{wq[3:]} logits against the bf16 model (request A's prompt "
          f"shape, not gated): {json.dumps(out)}", flush=True)
    return out


def weight_quant_serving(seed, gen, bf16_matmul_ms):
    """Phase 17: Llama-3-8B width, random bf16 weights from the seed (phase
    4's), through quantize_gpt_params as int8 and as int4: request A served
    through decode as a CUDA graph and uncaptured (serve: exact launches,
    graph tokens equal to eager tokens, the graph's logits against a second
    prefill), the kernel path against the plain path on the prefill and one
    decode step (phase 5's gate), the logits against the bf16 model, a
    profiled decode step; with int8 weights also the engine's 12 requests
    (bf16 pages, graph). Every number beside phase 4's bf16 one."""
    import dataclasses
    from xhy_flash_attention_tpu_torch import (GPTLMHeadModel,
                                               llama_config_to_gpt_config,
                                               quantize_gpt_params)
    cfg = llama_config_to_gpt_config(types.SimpleNamespace(**LLAMA3_8B),
                                     torch.bfloat16)
    model_f = GPTLMHeadModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    f_bytes = weight_bytes(model_f)
    bf16 = {what: SERVED[("A", what)] for what in ("eager", "graph")}
    out = {}
    for wq in ("int8", "int4"):
        t0 = time.perf_counter()
        cfg_q = dataclasses.replace(cfg, weight_quant=wq)
        model_q = GPTLMHeadModel(cfg_q, device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(seed))
        model_q.load_state_dict(quantize_gpt_params(model_f.state_dict(),
                                                    cfg_q))
        torch.cuda.synchronize()
        q_bytes = weight_bytes(model_q)
        print(f"  W{wq[3:]}: quantized and loaded in "
              f"{time.perf_counter() - t0:.1f} s; weights {q_bytes / 1e9:.3f}"
              f" GB (bf16: {f_bytes / 1e9:.3f} GB)", flush=True)
        check_quantized(model_q, model_f, wq)
        with count_plain_calls() as plain:
            serve(model_q, gen, "A")
        check(not plain, f"W{wq[3:]}: plain versions ran: {plain}")
        torch.cuda.empty_cache()
        kernel_vs_plain(model_q, gen, "A")
        torch.cuda.empty_cache()
        logits = quant_vs_float(model_q, model_f, gen, wq)
        torch.cuda.empty_cache()
        prof = decode_breakdown(model_q, gen, "A")
        matmul_ms = prof[True]["device_ms_per_step"].get("matmul", 0.0)
        served = {what: SERVED[("A", what)] for what in ("eager", "graph")}
        print(f"  W{wq[3:]} request A: graph ms/step "
              f"{served['graph']['ms_per_step']:.3f} (bf16 "
              f"{bf16['graph']['ms_per_step']:.3f}), eager "
              f"{served['eager']['ms_per_step']:.3f} (bf16 "
              f"{bf16['eager']['ms_per_step']:.3f}); decode tok/s graph "
              f"{served['graph']['tok_s']:.1f} (bf16 "
              f"{bf16['graph']['tok_s']:.1f}); prefill tok/s "
              f"{served['graph']['prefill_tok_s']:.1f} (bf16 "
              f"{bf16['graph']['prefill_tok_s']:.1f}); peak "
              f"{served['graph']['peak_gib']:.3f} GiB (bf16 "
              f"{bf16['graph']['peak_gib']:.3f}, both with the bf16 model "
              f"resident in this phase: {f_bytes / 2**30:.3f} GiB); the "
              f"graph step's matmul group {matmul_ms:.3f} ms (bf16, phase "
              f"6: {bf16_matmul_ms:.3f}); the dequantization's elementwise "
              "kernels fall in 'other'", flush=True)
        out[wq] = dict(weights_gb=q_bytes / 1e9, served=served,
                       payload=weight_bytes(model_q, True),
                       matmul_ms=matmul_ms, logits=logits)
        if wq == "int8":
            serve_engine(model_q, torch.bfloat16, seed)
            torch.cuda.empty_cache()
        del model_q
        torch.cuda.empty_cache()
    check(2 * out["int4"]["payload"] == out["int8"]["payload"],
          f"int4's projection weights ({out['int4']['payload']} bytes) do "
          f"not take half of int8's ({out['int8']['payload']})")
    print(f"  quantized projection weights: int8 {out['int8']['payload']} "
          f"bytes, int4 {out['int4']['payload']} (half)", flush=True)
    del model_f
    torch.cuda.empty_cache()
    return out


# ------------------- phase 3: the fp32 kernels; phases 18 and 19 (fp32)

PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate
# an fp32-accurate product on the tensor cores costs three TF32 products
# (3xTF32); the fp32 rows' bound: max(3 FLOPs / 495e12, bytes / 3.35e12)
FP32_PRODUCTS = 3
GPT2_XL = dict(  # openai-community/gpt2-xl config.json
    vocab_size=50257, n_positions=1024, n_embd=1600, n_layer=48, n_head=25,
    n_inner=None, layer_norm_epsilon=1e-5, activation_function="gelu_new",
    resid_pdrop=0.1, embd_pdrop=0.1, attn_pdrop=0.1, initializer_range=0.02)
G_REQUEST = (4, 896, 1024)  # batch, prompt, max_length
G_ATTN = dict(b=4, h=25, hk=25, s=896, d=64)  # G's prefill attention
# G's engine: 12 requests, prompts of 128-896 tokens, pages of 512, two a
# sequence (n_positions 1024), chunked prefill in pieces of 512. A chunk
# step writes 512 rows for every active slot, so every slot's length plus
# 512 must stay within the 1024 positions: all 12 requests are admitted at
# once (the chunk steps come first, before any slot has decoded more than
# one token), and no prompt is 512 long (it would take the bucketed
# prefill, then a second chunk step one token later would run past 1024).
G_ENGINE_RUN = dict(max_batch=12, page_size=512, max_pages_per_seq=2,
                    num_pages=25, prefill_chunk=512)
G_ENGINE_DECODE = dict(b=8, h=25, hk=25, d=64,
                       lengths=[1024, 960, 896, 700, 512, 300, 128, 0])
FP32_RECIPE = (f"{CONFIGS}/owt/gpt2m-flash.yaml",
               ("flash_fwd (fused_heads)", "flash_bwd_prep",
                "fused_heads_bwd"))
FP32_STEPS = 4


def fp32_bound(flops: float, nbytes: float):
    return bound(FP32_PRODUCTS * flops, PEAK_TF32_FLOPS, nbytes)


def attention64(q, k, v, *, sm_scale, causal, softcap=0.0, lengths=None,
                keep=None):
    """(out, lse) in float64 of (b, h, sq, d) q against (b, hk, sk, d) k/v
    (GQA by repeat): bottom-right causal, or with ``lengths`` (b,) each
    batch row's query i seeing keys j <= lengths[b] - sq + i; ``keep`` a
    dense keep mask (b|1, hm|1, sq, sk) of the mask flags (head i reads
    mask head i // (h / hm)); rows that see no key give 0 (lse -inf)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    s = (q.double() * sm_scale) @ k.double().repeat_interleave(
        g, 1).transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal or lengths is not None:
        last = (torch.full((b,), sk, device=q.device) if lengths is None
                else lengths.long())
        pos = last[:, None] - sq + torch.arange(sq, device=q.device)
        seen = torch.arange(sk, device=q.device) <= pos[:, :, None]
        s = s.masked_fill(~seen[:, None], float("-inf"))
    if keep is not None:
        from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
            expand_heads)
        s = s.masked_fill(~expand_heads(keep, q.shape[1]), float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.nan_to_num(torch.softmax(s, -1))
    return p @ v.double().repeat_interleave(g, 1), lse


def attention64_grads(q, k, v, do, **kw):
    """(out, lse, dq, dk, dv) in float64 by autograd of attention64 (also
    inside an autograd backward, where grad mode is off)."""
    with torch.enable_grad():
        ins = [t.detach().double().requires_grad_() for t in (q, k, v)]
        out, lse = attention64(*ins, **kw)
        grads = torch.autograd.grad(out, ins, do.double())
    return (out.detach(), lse) + grads


def fp32_contract(what, got, plain, want, tol_abs=1e-4):
    """The JAX contract for fp32 with its reference in float64: the
    kernel's error at most twice the fp32 plain version's plus 1e-4.
    Returns (error, plain error)."""
    keep = torch.isfinite(want)
    e = max_err(got[keep], want[keep])
    e_lp = max_err(plain[keep], want[keep])
    check(e <= 2 * e_lp + tol_abs,
          f"{what}: err vs float64 {e} > 2 x fp32 plain {e_lp} + {tol_abs}")
    return e, e_lp


def _fp32_inputs(gen, shape):
    """q, k, v, dO as (b, h, s, d) views of (b, s, heads, d) fp32 memory,
    the layout of the models' projections."""
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    return [torch.randn(b, s, n, d, generator=gen, device="cuda")
            .transpose(1, 2) for n in (h, hk, hk, h)]


def _sdpa_fp32(q, k, v, **kw):
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=q.shape[1] != k.shape[1], **kw)


def check_fp32_fwd(gen, label, shape, packed):
    """#1 in fp32 at ``shape`` (through flash_attention_fwd, or through
    fused_heads_fwd on the packed layout: #5): out and LSE against float64
    on the first batch element under the contract, beside the error of
    reference.py's emulation of the kernel's three TF32 products, against
    the fp32 plain version on all of it; SDPA in fp32 (TF32 off) timed
    beside, with its own error against float64. Bound: 3 TF32 products."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        fused_heads as fh, fwd)
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import (
        attention_fwd_tf32x3)
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    if packed:
        qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen, device="cuda")
        q, k, v = fh._split(qkv, h, hk, d)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def run():
            out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
            return out.transpose(1, 2), lse
    else:
        qt, kt, vt, _ = _fp32_inputs(gen, shape)

        def run():
            return fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
    out, lse = run()
    p_out, p_lse = fwd.attention_fwd_ref(qt, kt, vt, need_lse=True, **kw)
    w_out, w_lse = attention64(qt[:1], kt[:1], vt[:1], **kw)
    torch.cuda.synchronize()
    err = max(max_err(out, p_out), max_err(lse, p_lse))
    e, e_lp = fp32_contract(f"{label} out", out[:1], p_out[:1], w_out)
    el, el_lp = fp32_contract(f"{label} lse", lse[:1], p_lse[:1], w_lse)
    sdpa_err = max_err(_sdpa_fp32(qt[:1], kt[:1], vt[:1]), w_out)
    keep = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    emul = attention_fwd_tf32x3(qt[:1], kt[:1], vt[:1], sm_scale=kw["sm_scale"],
                                mask=keep)
    e3, el3 = max_err(emul[0], w_out), max_err(emul[1], w_lse)
    del p_out, p_lse, w_out, w_lse, emul
    flops = 4.0 * b * h * s * s * d / 2
    nbytes = 4.0 * b * s * d * (2 * h + 2 * hk) + 4.0 * b * h * s
    bms, by = fp32_bound(flops, nbytes)
    name = (f"flash_fwd_fp32 (fused_heads, {label})" if packed
            else f"flash_fwd_fp32 ({label})")
    row = dict(
        name=name, route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu",
        replaces=("xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:59"
                  if packed else
                  "xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78"),
        max_abs_err=err, ms=graph_ms([run], reps=4, replays=5),
        plain_ms=time_ms([lambda: fwd.attention_fwd_ref(
            qt, kt, vt, need_lse=False, **kw)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda: _sdpa_fp32(qt, kt, vt)], reps=4,
                            replays=5))
    report(row, f"vs the fp32 plain version (out, lse); vs float64 on batch "
                f"0: out {e:.3g} <= 2 x fp32 plain {e_lp:.3g} + 1e-4 "
                f"(three-product emulation {e3:.3g}), lse {el:.3g} (plain "
                f"{el_lp:.3g}, emulation {el3:.3g}); SDPA fp32's own error "
                f"{sdpa_err:.3g}; {label}: b{b} h{h} hk{hk} s{s} d{d} causal"
                f"{' packed' if packed else ''}, flops {flops:.4g}, bytes "
                f"{nbytes:.4g}, {flops / row['ms'] / 1e9:.2f} TFLOP/s, "
                f"{bms / row['ms']:.3f} of the bound (3 TF32 products at "
                f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, by {by}); ms and "
                "library_ms from CUDA graphs")
    return row


def check_fp32_bwd(gen, label, shape, packed):
    """The whole fp32 backward at ``shape``: the pre-pass, dK/dV (#2) and
    dQ (#3) through flash_attention_bwd, or one packed dqkv through
    fused_heads_bwd (#6): every gradient against float64 on the first
    batch element under the contract and against the fp32 plain version;
    three passes bitwise equal; SDPA's fp32 backward beside. Returns the
    rows (packed: one for the whole backward; else the pre-pass and each
    kernel)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, fused_heads as fh, fwd)
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import (
        attention_bwd_tf32x3)
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    if packed:
        qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen, device="cuda")
        q, k, v = fh._split(qkv, h, hk, d)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda")
        out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
        dqkv = torch.empty_like(qkv)
        dst = dict(zip(("dq", "dk", "dv"), fh._split(dqkv, h, hk, d)))
        qt, kt, vt, dot, ot = (t.transpose(1, 2) for t in (q, k, v, do, out))

        def run():
            return [g.transpose(1, 2) for g in fh.fused_heads_bwd(
                q, k, v, out, lse, do, **kw, **dst)]
    else:
        qt, kt, vt, dot = _fp32_inputs(gen, shape)
        ot, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)

        def run():
            return bwd.flash_attention_bwd(qt, kt, vt, ot, lse, dot, **kw)
    grads = [g.clone() for g in run()]
    p_grads = bwd.attention_bwd_ref(qt, kt, vt, ot, lse, dot, **kw)
    err = max(max_err(g, p) for g, p in zip(grads, p_grads))
    del p_grads
    # the fp32 plain path end to end (its own forward) and float64, batch
    # 0; beside them reference.py's emulation of the kernels' three TF32
    # products on the plain forward's out and LSE
    one = [t[:1] for t in (qt, kt, vt, dot)]
    p_out, p_lse = fwd.attention_fwd_ref(*one[:3], need_lse=True, **kw)
    p_one = bwd.attention_bwd_ref(*one[:3], p_out, p_lse, one[3], **kw)
    want = attention64_grads(*one, **kw)[2:]
    s1 = one[0].shape[2]
    keep = torch.ones(s1, s1, dtype=torch.bool, device="cuda").tril()
    emul = attention_bwd_tf32x3(*one[:3], p_out, p_lse, one[3],
                                sm_scale=kw["sm_scale"], mask=keep)
    errs = []
    for n, g, p, e, w in zip(("dq", "dk", "dv"), grads, p_one, emul, want):
        errs.append((n,) + fp32_contract(f"{label} {n}", g[:1], p, w)
                    + (max_err(e, w),))
    worst = max(e[1:3] for e in errs)
    del p_one, want, emul
    emul_note = ", ".join(f"{n} kernel {e:.3g} (three-product emulation "
                          f"{e3:.3g}, fp32 plain {ep:.3g})"
                          for n, e, ep, e3 in errs)
    _bitwise_three_passes(lambda: [g.clone() for g in run()],
                          f"fp32 attention backward at {label}")
    pair = 2.0 * b * h * s * s * d / 2
    io = 4.0 * b * s * d * (2 * h + 2 * hk)      # q, dO, k, v
    stats = 2 * 4.0 * b * h * s                   # lse, delta
    grads_out = 4.0 * b * s * d * (h + 2 * hk)    # dq, dk, dv
    plain_ms = time_ms([lambda: bwd.attention_bwd_ref(
        qt, kt, vt, ot, lse, dot, **kw)], iters=3, warmup=1)
    library = _sdpa_bwd_ms(qt, kt, vt, dot)
    src = "xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu"
    note = (f"vs the fp32 plain backward; vs float64 on batch 0: worst "
            f"{worst[0]:.3g} <= 2 x fp32 plain {worst[1]:.3g} + 1e-4 "
            f"({emul_note}); three "
            f"passes bitwise equal; b{b} h{h} hk{hk} s{s} d{d} causal; "
            "plain_ms and library_ms (SDPA fp32 fwd + bwd minus fwd) of the "
            "whole backward")
    if packed:
        bms, by = fp32_bound(5 * pair, io + stats + grads_out)
        row = dict(name=f"fused_heads_bwd (fp32, {label})", route="cuda",
                   source=src, replaces="xhy_flash_attention_tpu/ops/"
                                        "flash_attention/fused_heads.py:105",
                   max_abs_err=err, ms=time_ms([run], iters=5),
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=library)
        report(row, note + "; ms includes the pre-pass and both kernels, "
                           "5-product bound")
        return [row]
    qs, delta = bwd.flash_bwd_prep(qt, ot, dot, sm_scale=kw["sm_scale"])
    want_qs, want_delta = bwd.bwd_prep_ref(qt, ot, dot, sm_scale=kw["sm_scale"])
    torch.cuda.synchronize()
    err_delta = max_err(delta, want_delta)
    check(torch.equal(qs, want_qs) and
          err_delta <= 1e-5 * want_delta.abs().max().item(),
          f"fp32 pre-pass at {label}: q_s differs or delta err {err_delta}")
    del want_qs, want_delta
    nbytes = 4.0 * b * h * s * d * 4 + 4.0 * b * h * s
    bms, by = fp32_bound(2.0 * b * h * s * d, nbytes)
    rows = [dict(name=f"flash_bwd_prep (fp32, {label})", route="cuda",
                 source="xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu",
                 replaces="xhy_flash_attention_tpu/ops/flash_attention/bwd.py:737",
                 max_abs_err=err_delta,
                 ms=time_ms([lambda: bwd.flash_bwd_prep(
                     qt, ot, dot, sm_scale=kw["sm_scale"])]),
                 plain_ms=time_ms([lambda: bwd.bwd_prep_ref(
                     qt, ot, dot, sm_scale=kw["sm_scale"])], iters=5),
                 bound_ms=bms, bound_by=by, library_ms=None)]
    report(rows[0], f"q_s bitwise equal, delta within 1e-5 of max|delta|; "
                    f"b{b} h{h} s{s} d{d}, bytes {nbytes:.4g}; no single "
                    "library call")
    dq, dk, dv = (torch.empty_like(g) for g in grads)
    args = (qs, kt, vt, dot, lse, delta, dq, dk, dv)
    kw32 = dict(sm_scale=kw["sm_scale"], window=(-1, 0), softcap=0.0)
    for name, fn, n_mm, out_bytes, replaces in (
            ("flash_bwd_dkv_fp32", bwd.flash_bwd_dkv_fp32, 4,
             2 * 4.0 * b * s * hk * d, "bwd.py:180"),
            ("flash_bwd_dq_fp32", bwd.flash_bwd_dq_fp32, 3,
             4.0 * b * s * h * d, "bwd.py:511")):
        bms, by = fp32_bound(n_mm * pair, io + stats + out_bytes)
        row = dict(name=f"{name} ({label})", route="cuda", source=src,
                   replaces="xhy_flash_attention_tpu/ops/flash_attention/"
                            + replaces,
                   max_abs_err=err,
                   ms=time_ms([lambda fn=fn: fn(*args, **kw32)], iters=5),
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=library)
        report(row, note + f"; {n_mm} products, "
                           f"{n_mm * pair / row['ms'] / 1e9:.2f} TFLOP/s")
        rows.append(row)
    whole = time_ms([run], iters=5)
    bms, by = fp32_bound(5 * pair, io + stats + grads_out)
    print(f"  fp32 attention backward ({label}): whole {whole:.4f} ms "
          f"(pre-pass {rows[0]['ms']:.4f} + dK/dV {rows[1]['ms']:.4f} + dQ "
          f"{rows[2]['ms']:.4f}) against SDPA fp32's {library:.4f} ms "
          f"(x{whole / library:.3f}) and the bound {bms:.4f} ms by {by} "
          f"(share {bms / whole:.3f})", flush=True)
    return rows


def _g_decode_caches(gen, n_sets=3):
    """(q, [(k, v) fp32 caches], lengths) at G's last decode step: b4 h25
    d64, caches of n_positions 1024, full; copies rotated past L2."""
    b, _, max_len = G_REQUEST
    h, d = G_ATTN["h"], G_ATTN["d"]
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda")
    sets = [[torch.randn(b, h, max_len, d, generator=gen, device="cuda")
             for _ in range(2)] for _ in range(n_sets)]
    lengths = torch.full((b,), max_len, dtype=torch.int32, device="cuda")
    return q, sets, lengths


def check_fp32_decode(gen, split: bool):
    """#4 (flash_decode) or, with ``split``, #9 (flash_decode_splitkv, the
    heuristic's split count) on fp32 caches at G's last decode step,
    against the plain version within 1e-5 of the largest output; ragged
    lengths first. SDPA in fp32 beside."""
    from xhy_flash_attention_tpu_torch.inference import combine
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    q, sets, lengths = _g_decode_caches(gen)
    b, _, h, d = q.shape
    kc, vc = sets[0]
    scale = d ** -0.5
    ragged = lengths.clone()
    ragged[1::2] -= 29
    fn = ((lambda kc, vc, ln: combine.flash_decode_splitkv(q, kc, vc, ln))
          if split else
          (lambda kc, vc, ln: dk.flash_decode(q, kc, vc, ln,
                                              softmax_scale=scale)))
    ref = dk.flash_decode_ref(q, kc, vc, lengths, scale)
    err = max(max_err(fn(kc, vc, ln), dk.flash_decode_ref(q, kc, vc, ln, scale))
              for ln in (ragged, lengths))
    torch.cuda.synchronize()
    tol = 1e-5 * ref.abs().max().item()
    name = f"flash_decode{'_splitkv' if split else ''} (fp32, G)"
    check(err <= tol, f"{name}: err {err} > {tol}")
    n_tok = int(lengths.sum().item())
    nbytes = 2 * 4.0 * h * n_tok * d + 2 * 4.0 * b * h * d
    bms, by = fp32_bound(4.0 * h * n_tok * d, nbytes)
    row = dict(
        name=name, route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_decode.cu",
        replaces=("xhy_flash_attention_tpu/inference/combine.py:75" if split
                  else "xhy_flash_attention_tpu/ops/flash_attention/"
                       "decode_kernel.py:47"),
        max_abs_err=err,
        ms=graph_ms([lambda kc=kc, vc=vc: fn(kc, vc, lengths)
                     for kc, vc in sets]),
        plain_ms=graph_ms([lambda: dk.flash_decode_ref(
            q, kc, vc, lengths, scale)], reps=2, replays=5),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc) for kc, vc in sets]))
    splits = combine._split_plan(q, kc, 0, 512) if split else (1, 0)
    report(row, f"tol {tol:.3g} = 1e-5 of max|out|; G last step: b{b} h{h} "
                f"len {lengths[0].item()} d{d}, fp32 caches, bytes "
                f"{nbytes:.4g}, {len(sets)} cache copies rotated; splits "
                f"{splits}; {_plan_text(q, kc, *splits)}; CUDA graphs of "
                "calls; library: SDPA fp32")
    return row


def check_fp32_paged(gen, shape, entry, sq):
    """#10 / #11 on fp32 pages (fp32 queries): the decode regime (sq * g <=
    16) or the prefill regime (csrc/flash_fp32.cu's paged forward), at
    ``shape`` (G_ENGINE_DECODE: G's engine, pages of 512, two a sequence;
    ENGINE_DECODE: the Llama-3-8B engine's), against the plain version
    within 1e-5 of the largest output, two calls bitwise equal; SDPA fp32
    with a mask on the dense-equivalent cache beside."""
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.inference.paged import PagedKVCache
    c = shape
    b, h, hk, d = c["b"], c["h"], c["hk"], c["d"]
    ps = 4096 if entry == "page" and d == 128 else 512
    npp = (max(c["lengths"]) + ps - 1) // ps
    n_sets = 3
    P = n_sets * b * npp + 1
    kv = torch.randn(P, hk, 2, ps, d, generator=gen, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32)
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
    sets = [PagedKVCache(kv, perm[i * b * npp:(i + 1) * b * npp].reshape(
        b, npp).contiguous(), lengths) for i in range(n_sets)]
    fn = getattr(paged, f"paged_decode_{entry}")
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda")
    scale = d ** -0.5
    cache = sets[0]
    before = fn.launches
    out = paged.paged_flash_decode(q, cache)
    check(fn.launches == before + 1, f"paged_flash_decode did not route to "
                                     f"the {entry} entry")
    again = paged.paged_flash_decode(q, cache)
    ref = paged.paged_flash_decode_ref(q, cache, scale)
    torch.cuda.synchronize()
    what = f"paged_decode ({entry}, fp32" + (f", sq {sq})" if sq > 1 else ")")
    check(torch.equal(out, again), f"{what}: two calls differ")
    err, tol = max_err(out, ref), 1e-5 * ref.abs().max().item()
    check(err <= tol, f"{what}: err {err} > {tol}")
    check(not out[-1].abs().any(), "the empty slot is not zero")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = paged.paged_launch_plan(b, sq, h, hk, ps, npp, sms)
    cap = ps * npp
    n_tok = sum(min(L, cap) for L in c["lengths"])
    nbytes = 2 * 4.0 * hk * n_tok * d + 2 * 4.0 * b * sq * h * d + 4.0 * b * npp
    flops = 4.0 * h * d * _visible_pairs(c["lengths"], sq, cap)
    bms, by = fp32_bound(flops, nbytes)
    k, v, _, _ = paged._gather(cache)
    k, v = (x.repeat_interleave(h // hk, dim=1) for x in (k, v))
    pos = lengths.long()[:, None] - sq + torch.arange(sq, device="cuda")
    mask = (torch.arange(cap, device="cuda")[None, None] <= pos[:, :, None])[:, None]
    del ref, out, again
    row = dict(
        name=what + (" G" if shape is G_ENGINE_DECODE else ""), route="cuda",
        source=("xhy_flash_attention_tpu_torch/csrc/paged_decode.cu"
                if sq * (h // hk) <= 16 else
                "xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu"),
        replaces=("xhy_flash_attention_tpu/inference/paged.py:219"
                  if entry == "chunked" else
                  "xhy_flash_attention_tpu/inference/paged.py:149"),
        max_abs_err=err,
        ms=graph_ms([lambda s=s: paged.paged_flash_decode(q, s) for s in sets]),
        plain_ms=time_ms([lambda: paged.paged_flash_decode_ref(
            q, cache, scale)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms([lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask)]))
    report(row, f"tol {tol:.3g} = 1e-5 of max|out| (P in fp32 on both "
                f"sides); two calls bitwise equal; b{b} h{h} hk{hk} d{d} sq "
                f"{sq}, pages of {ps}, {npp} per sequence, lengths "
                f"{c['lengths']}, flops {flops:.4g}, bytes {nbytes:.4g}; plan "
                f"{json.dumps(plan)}; CUDA graphs of calls; library: SDPA "
                "fp32 with a mask on the dense-equivalent cache")
    del sets, k, v, mask, kv
    torch.cuda.empty_cache()
    return row


def fp32_kernels(gen):
    """Phase 3's fp32 rows. The paged rows at the Llama-3-8B engine's shape
    (d 128: the chunked entry, #11, and the page entry over one page of
    4096) are printed and left out of the kernels line: no fp32 model of
    this run has d 128, and G's engine (d 64) takes the page entry, whose
    rows at G's engine shape are in the line. Returns the rows of the
    line."""
    print(f"  torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32} (SDPA and the matmuls in full "
          "fp32)", flush=True)
    t_packed = dict(T_PACKED)
    rows = [check_fp32_fwd(gen, "G prefill", G_ATTN, False),
            check_fp32_fwd(gen, "T-packed", t_packed, True)]
    torch.cuda.empty_cache()
    rows += check_fp32_bwd(gen, "G shape", G_ATTN, False)
    torch.cuda.empty_cache()
    rows += check_fp32_bwd(gen, "T-packed", t_packed, True)
    torch.cuda.empty_cache()
    rows += [check_fp32_decode(gen, split=False),
             check_fp32_decode(gen, split=True)]
    rows += [check_fp32_paged(gen, G_ENGINE_DECODE, "page", 1),
             check_fp32_paged(gen, G_ENGINE_DECODE, "page", 512)]
    for entry, sq in (("chunked", 1), ("chunked", 512), ("page", 1)):
        check_fp32_paged(gen, ENGINE_DECODE, entry, sq)
    return rows


# ------------------------- phase 3's fp32 rows under masks and fp32 #12

# float64 references on a subset of at most this many bytes of scores
FP64_SUBSET_BYTES = 2.2e9


def fp32_subset_contract(label, ins, got, masks, eff, n_tok):
    """The fp32 contract against float64 (fp32_contract) on batch 0, whole
    kv-head groups (FP64_SUBSET_BYTES of float64 scores at most) and the
    first ``n_tok`` tokens, a prefix no visible pair crosses: the kernels'
    out, LSE, dq, dk, dv (``got``) and the fp32 plain version's on the
    same subset against float64 with the mask flags' keep mask. Rows that
    see nothing must have the kernels' LSE +inf and out 0. Returns
    {what: (err, fp32 plain err)}."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, common, fwd)
    q, k, v, do = ins
    h, hk, d = q.shape[1], k.shape[1], q.shape[3]
    g = h // hk
    n_kv = max(1, min(hk, int(FP64_SUBSET_BYTES // (g * n_tok * n_tok * 8))))
    cut = (lambda t, heads: t[:1, :heads, :n_tok].contiguous())
    sub = [cut(q, g * n_kv), cut(k, n_kv), cut(v, n_kv), cut(do, g * n_kv)]
    keep = common.expand_heads(masks.keep(h, "cuda"), h)
    keep = keep[:1, :g * n_kv if keep.shape[1] > 1 else 1, :n_tok, :n_tok]
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    p_out, p_lse = fwd.attention_fwd_ref(*sub[:3], need_lse=True, mask=keep,
                                         **kw)
    plain = (p_out, p_lse) + bwd.attention_bwd_ref(*sub[:3], p_out, p_lse,
                                                   sub[3], mask=keep, **kw)
    want = attention64_grads(*sub, sm_scale=d ** -0.5, causal=eff, keep=keep)
    mine = [cut(t, g * n_kv if i in (0, 1, 2) else n_kv)
            for i, t in enumerate(got)]
    seen = torch.isfinite(want[1])
    check(bool(torch.isinf(mine[1][~seen]).all())
          and not mine[0][~seen].abs().any(),
          f"{label}: a row that sees nothing is not 0 with LSE +inf")
    errs = {}
    for what, a, pl, w in zip(("out", "lse", "dq", "dk", "dv"), mine, plain,
                              want):
        if what == "lse":
            a, pl, w = a[seen], pl[seen], w[seen]
        errs[what] = fp32_contract(f"{label} {what}", a, pl, w)
    print(f"  {label}: vs float64 on batch 0, {g * n_kv} heads, "
          f"{n_tok} tokens ({int((~seen).sum())} rows see nothing): "
          + ", ".join(f"{w_} {e:.3g} <= 2 x fp32 plain {ep:.3g} + 1e-4"
                      for w_, (e, ep) in errs.items()), flush=True)
    return errs


def check_sparse_fp32(gen, label, shape, causal, make_flags, n_tok=None):
    """Phase 3 rows of the masked fp32 forward (#1), dK/dV (#2) and dQ (#3)
    kernels (csrc/flash_fp32.cu) at ``shape`` under the flags of
    ``make_flags``: the contract against float64 on a subset
    (fp32_subset_contract; ``n_tok`` its token prefix, all by default);
    against the fp32 plain version on all of it (by kv-head groups: 1e-4
    of the largest |ref|, + 1e-5 for out); three backward passes bitwise
    equal; the timed launches (the mask arguments made once) into
    NaN-filled buffers equal to the checked outputs; the tiles they visit
    equal to the fp32 mirrors of fwd.py and bwd.py; bounds from the visible
    pairs (3 TF32 products at 495 TFLOP/s), SDPA fp32 (TF32 off) with the
    dense mask as the library call."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = _dims(shape)
    f32 = torch.float32
    q, k, v, do = _sparse_inputs(gen, shape, f32)
    flags = make_flags(gen)
    eff, masks = fwd.build_masks(b, h, s, s, causal, **flags)
    dense = masks.keep(h, "cuda")
    kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
    out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw,
                                       masks=masks)
    grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw, masks=masks)
    torch.cuda.synchronize()
    fp32_subset_contract(label, (q, k, v, do), (out, lse, *grads), masks,
                         eff, n_tok or s)
    torch.cuda.empty_cache()
    ref, ref_lse = plain_fwd_groups(q, k, v, dense, **kw)
    fin = torch.isfinite(ref_lse)
    check(torch.equal(fin, torch.isfinite(lse)),
          f"flash_fwd_fp32 ({label}): rows with no key differ")
    err = max_err(out, ref)
    tol = 1e-4 * ref.abs().max().item() + 1e-5
    err_lse = max_err(lse[fin], ref_lse[fin])
    check(err <= tol and err_lse <= 1e-4,
          f"flash_fwd_fp32 ({label}): err {err} > {tol} or lse err {err_lse}")
    del ref, ref_lse
    want = plain_bwd_groups(q, k, v, out, lse, do, dense, **kw)
    torch.cuda.synchronize()
    err_dq = max_err(grads[0], want[0])
    err_dkv = max(max_err(grads[1], want[1]), max_err(grads[2], want[2]))
    gtol = 1e-4 * max(w.abs().max().item() for w in want)
    check(max(err_dq, err_dkv) <= gtol,
          f"flash_bwd fp32 ({label}): err vs plain {err_dq}, {err_dkv} > "
          f"{gtol}")
    del want
    _bitwise_three_passes(lambda: [t.clone() for t in bwd.flash_attention_bwd(
        q, k, v, out, lse, do, **kw, masks=masks)],
        f"fp32 masked backward at {label}")
    keep = _causal_part(dense, eff, s, s)
    n_vis = visible_pairs(keep, b, h)
    share = n_vis / (b * h * s * s)
    lib_fwd, lib_bwd = _sdpa_masked_ms(q, k, v, do, keep)
    del keep
    torch.cuda.empty_cache()
    io = 4.0 * b * s * d * (2 * h + 2 * hk)  # q, o | do and k, v (fp32)
    shape_txt = (f"b{b} h{h} hk{hk} s{s} d{d} "
                 f"{'causal' if causal else 'full'}")
    masks.bands()  # made once, as the stats
    fwd_out = torch.full_like(out, float("nan"))
    fwd_counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fwd.launch_flash_fwd(q, k, v, fwd_out, None, masks=masks,
                         tile_counts=fwd_counts, **kw)
    torch.cuda.synchronize()
    check(torch.equal(fwd_out, out),
          f"flash_fwd_fp32 ({label}): the timed launch differs from the "
          "checked output")
    bms, by = fp32_bound(2 * 2 * d * n_vis, io)
    src = "xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu"
    rows = [dict(
        name=f"flash_fwd_fp32 ({label})", route="cuda", source=src,
        replaces="xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78",
        max_abs_err=err,
        ms=time_ms([lambda: fwd.launch_flash_fwd(
            q, k, v, fwd_out, None, masks=masks, **kw)]),
        plain_ms=time_ms([lambda: plain_fwd_groups(q, k, v, dense, **kw)],
                         iters=2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=lib_fwd)]
    report(rows[0], f"tol {tol:.3g} = 1e-4 of max|out| + 1e-5 vs the fp32 "
                    f"plain version; lse err {err_lse:.3g}; {shape_txt}, "
                    f"visible share {share:.4f}, flops {4 * d * n_vis:.4g}, "
                    f"{bms / rows[0]['ms']:.3f} of the bound (3 TF32 "
                    f"products at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, by "
                    f"{by}); library: SDPA fp32 with the dense boolean mask")
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in grads)
    args = (qs, k, v, do, lse, delta, dq, dk, dv)
    kw32 = dict(sm_scale=kw["sm_scale"], window=fwd.fp32_window(masks, eff),
                softcap=0.0, masks=masks, causal=eff)
    counted = [fwd_counts[1:].tolist()]
    for fn in (bwd.flash_bwd_dkv_fp32, bwd.flash_bwd_dq_fp32):
        counts = torch.zeros(3, dtype=torch.int32, device="cuda")
        fn(*args, tile_counts=counts, **kw32)
        counted.append(counts[1:].tolist())
    mirror = mirror_tile_counts(masks, b, h, hk, s, eff, d, fp32=True)
    check(counted == [m[:2] for m in mirror],
          f"flash_fp32 ({label}): the kernels visited {counted} tiles "
          f"(visited, elementwise), the mirrors {mirror}")
    print(f"  tile plan ({label}, counted by the fp32 kernels, equal to "
          "fwd.py's and bwd.py's fp32 mirrors): " + "; ".join(
              f"{name} {n} visited ({e} elementwise), {c - n} of {c} skipped"
              for name, (n, e, c) in zip(("forward", "dK/dV", "dQ"), mirror)),
          flush=True)
    stats = 2 * 4.0 * b * h * s  # lse, delta (fp32)
    plain_ms = time_ms([lambda: plain_bwd_groups(
        q, k, v, out, lse, do, dense, **kw)], iters=1, warmup=1)
    bwd_rows = []
    for name, fn, n_mm, out_bytes, e, replaces in (
            ("flash_bwd_dkv_fp32", bwd.flash_bwd_dkv_fp32, 4,
             2 * 4.0 * b * s * hk * d, err_dkv, "bwd.py:180"),
            ("flash_bwd_dq_fp32", bwd.flash_bwd_dq_fp32, 3,
             4.0 * b * s * h * d, err_dq, "bwd.py:511")):
        bms, by = fp32_bound(n_mm * 2 * d * n_vis, io + stats + out_bytes)
        row = dict(
            name=f"{name} ({label})", route="cuda", source=src,
            replaces="xhy_flash_attention_tpu/ops/flash_attention/" + replaces,
            max_abs_err=e,
            ms=time_ms([lambda fn=fn: fn(*args, **kw32)], iters=10),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_bwd)
        report(row, f"tol {gtol:.3g} = 1e-4 of max|grad| vs the fp32 plain "
                    f"backward; {shape_txt}, visible share {share:.4f}, "
                    f"{n_mm} products over the visible pairs, "
                    f"{bms / row['ms']:.3f} of the bound; plain_ms and "
                    "library_ms of the whole backward (SDPA fp32 with the "
                    "dense mask, fwd + bwd minus fwd)")
        bwd_rows.append(row)
    check(all(torch.equal(a, c) for a, c in zip((dq, dk, dv), grads)),
          f"flash_bwd fp32 ({label}): the timed launches differ from the "
          "checked gradients")
    summed = bwd_rows[0]["ms"] + bwd_rows[1]["ms"]
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import (
        KernelMasks)

    def mask_args():  # the host's part of a call: flags, stats, ranges
        made = fwd.build_masks(b, h, s, s, causal, **flags)[1]
        for kind in ("fwd_fp32", "dkv_fp32", "dq_fp32"):
            KernelMasks.c_args(made, eff, kind, d)
        made.bands()
    entry = time_ms([lambda: fwd.flash_attention_fwd(
        q, k, v, need_lse=False, sm_scale=kw["sm_scale"], causal=causal,
        **flags)])
    print(f"  fp32 attention backward ({label}): dK/dV + dQ {summed:.4f} ms; "
          f"SDPA fp32 backward with the mask {lib_bwd:.4f} ms; the entry's "
          f"forward with its mask arguments made per call {entry:.4f} ms "
          f"(kernel {rows[0]['ms']:.4f}); the mask arguments of the three "
          f"fp32 kernels alone (stats, token stats and ranges at their "
          f"tiles, bands) {time_ms([mask_args], iters=5):.4f} ms", flush=True)
    return rows + bwd_rows, (q, k, lse)


def check_reduced_fp32(q, k, lse):
    """Phase 3 row of the fp32 reduced-scores kernel (#12 in fp32,
    csrc/flash_fp32.cu reduced_scores_fp32_kernel) at FM-swg's shape on the
    LSE of FM-swg-fp32's masked forward: against the fp32 plain version
    (1e-4 of the largest score) and float64 (the fp32_gate form: at most
    twice the fp32 plain version's error + 1e-4 of the largest score; the
    sums reach hundreds), bitwise equal across two launches. No single
    PyTorch call computes the function: library_ms is null."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        reduced_scores as rs)
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    got = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    again = rs.calc_reduced_attn_scores(q, k, lse, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "reduced_scores fp32: two launches differ")
    plain = torch.cat([rs.reduced_scores_ref(
        q[:, j * g:(j + 1) * g], k[:, j:j + 1], lse[:, j * g:(j + 1) * g],
        sm_scale=d ** -0.5, causal=True) for j in range(hk)], 1)
    err = max_err(got, plain)
    tol = 1e-4 * plain.abs().max().item()
    check(err <= tol, f"reduced_scores fp32 err {err} > {tol}")
    rows = torch.arange(s, device="cuda")[:, None] + 0
    cols = torch.arange(s, device="cuda")[None]
    hidden = cols > rows  # the causal superset, sq == sk
    want = []
    for j in range(hk):  # float64, a kv-head group at a time
        sc = (q[:, j * g:(j + 1) * g].double() @ k[:, j:j + 1].double()
              .transpose(-1, -2)) * d ** -0.5
        p = torch.exp(sc - lse[:, j * g:(j + 1) * g].double()[..., None])
        want.append(p.masked_fill(hidden, 0.0).sum(-2))
        del sc, p
    gate = fp32_gate("reduced_scores fp32 (FM-swg-fp32)", got, plain,
                     torch.cat(want, 1))
    del want
    n_vis = b * h * s * (s + 1) / 2.0  # the causal region
    nbytes = 4.0 * b * s * d * (h + hk) + 4.0 * b * h * s * 2  # q, k | lse, out
    bms, by = fp32_bound(2 * d * n_vis, nbytes)
    floor = exp_floor_ms(n_vis)
    if floor > bms:
        bms, by = floor, "operations"
    row = dict(
        name="reduced_scores (fp32, FM-swg-fp32)", route="cuda",
        source="xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu",
        replaces=("xhy_flash_attention_tpu/ops/flash_attention/"
                  "reduced_scores.py:34"),
        max_abs_err=err,
        ms=time_ms([lambda: rs.calc_reduced_attn_scores(q, k, lse,
                                                        causal=True)]),
        plain_ms=time_ms([lambda: [rs.reduced_scores_ref(
            q[:, j * g:(j + 1) * g], k[:, j:j + 1], lse[:, j * g:(j + 1) * g],
            sm_scale=d ** -0.5, causal=True) for j in range(hk)]],
            iters=2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    report(row, f"tol {tol:.3g} = 1e-4 of max|score| vs the fp32 plain "
                f"version; vs float64 {gate['kernels']:.3g} (fp32 plain "
                f"{gate['plain']:.3g}); two launches bitwise equal; b{b} h{h} "
                f"hk{hk} s{s} d{d} causal, 3 TF32 products of "
                f"{2 * d * n_vis:.4g} flops, exponent floor {floor:.4f} ms; "
                f"{bms / row['ms']:.3f} of the bound; library: none (no "
                "single PyTorch call computes it)")
    return row


def fp32_masked_kernels(gen):
    """Phase 3's masked fp32 rows: FM-doc-fp32, BS-fp32,
    FM-swg-fp32 (then #12 in fp32 on its LSE) and VL-doc-fp32 (its float64
    subset the documents of the first 4096 tokens or so). Returns the rows
    of the line."""
    gen = own_gen(gen, 1803)
    b, _, _, s, _ = _dims(FM_DOC)
    rows, _ = check_sparse_fp32(
        gen, "FM-doc-fp32", FM_DOC, True,
        lambda g: _flags(doc_indices(g, b, s), causal=True))
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(BS)
    more, _ = check_sparse_fp32(
        gen, "BS-fp32", BS, False,
        lambda g: _flags(block_mask=bigbird_mask(g, b, s // BS_BLOCK)))
    rows += more
    torch.cuda.empty_cache()
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    b, _, _, s, _ = _dims(FM_SWG)
    more, qkl = check_sparse_fp32(
        gen, "FM-swg-fp32", FM_SWG, True,
        lambda g: _flags(global_sliding_window_mask(
            b, s, SWG_WINDOW, SWG_GLOBAL), causal=True))
    rows += more
    torch.cuda.empty_cache()
    rows.append(check_reduced_fp32(*qkl))
    del qkl
    torch.cuda.empty_cache()
    s = VL_DOC["s"]
    cu = doc_cu_seqlens(gen, s, *VL_DOC_LENGTHS)
    n_tok = int(cu[cu >= 4096][0].item())  # a document boundary
    more, _ = check_sparse_fp32(gen, "VL-doc-fp32", VL_DOC, True,
                                lambda g: vl_flags(cu, cu, s, s), n_tok=n_tok)
    rows += more
    torch.cuda.empty_cache()
    return rows


# ------------------------------------ phase 18: GPT-2 XL in fp32 (cell G)

def gpt2_xl_state_dict(seed: int, hf):
    """A GPT2LMHeadModel state dict under Hugging Face's key names (Conv1D
    weights (in, out)), numpy fp32, random from ``seed``: normal(0, 0.02)
    weights and embeddings, LayerNorm weights 1 + normal(0, 0.02), biases
    normal(0, 0.02)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    e, inner = hf.n_embd, hf.n_inner or 4 * hf.n_embd

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(hf.initializer_range))

    sd = {"transformer.wte.weight": w(hf.vocab_size, e),
          "transformer.wpe.weight": w(hf.n_positions, e),
          "transformer.ln_f.weight": 1 + w(e), "transformer.ln_f.bias": w(e)}
    for i in range(hf.n_layer):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + w(e), w(e)
        for name, (fan_in, fan_out) in (("attn.c_attn", (e, 3 * e)),
                                        ("attn.c_proj", (e, e)),
                                        ("mlp.c_fc", (e, inner)),
                                        ("mlp.c_proj", (inner, e))):
            sd[p + name + ".weight"] = w(fan_in, fan_out)
            sd[p + name + ".bias"] = w(fan_out)
    return sd


def g_expected_counts(prompt: int, max_length: int):
    """The launches of one decode() run of the GPT-2 XL model: its prefill
    through the fp32 forward (h d = 1600 is not a multiple of 128: no
    packed heads), every step through flash_decode on fp32 caches."""
    steps, layers = max_length - prompt, GPT2_XL["n_layer"]
    return {**{k: 0 for k in counters()},
            "rms_norm_add": (2 * layers + 1) * (1 + steps),
            "flash_fwd_fp32": layers, "flash_decode": layers * steps}


def _g_engine_requests(seed: int, vocab: int):
    """12 prompts of 128-896 tokens (none of 512: G_ENGINE_RUN) and
    max_new_tokens of 16-64, drawn once from the seed (prompt + new tokens
    within n_positions 1024)."""
    import numpy as np
    from xhy_flash_attention_tpu_torch.inference import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 897, N_REQUESTS)
    lens[lens == 512] = 511
    news = rng.integers(16, 65, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(lens, news))]


@contextlib.contextmanager
def float64_versions():
    """Route the model's kernel calls to float64 plain versions (layer norm,
    the attention forward and backward, packed or not, and decode), which
    run on the card's tensors in float64: with the model's parameters in
    float64, the anchor of the fp32 gates. Restored on exit."""
    ln = importlib.import_module(_PKG + "layer_norm")
    fh = importlib.import_module(_PKG + "flash_attention.fused_heads")
    iface = importlib.import_module(_PKG + "flash_attention.interface")
    dec = importlib.import_module(_PKG + "decode")

    def no_flags(flags):
        check(not any(v for k, v in flags.items() if k != "x0"),
              "the float64 versions take no dropout, rowscale or colscale")

    def ln_fwd(x0, residual, weight, bias, eps, is_rms, res_dtype,
               save_resout, save_stats=False, **flags):
        no_flags(flags)
        x = x0.double() + (0 if residual is None else residual.double())
        mu = None if is_rms else x.mean(-1, keepdim=True)
        xc = x if is_rms else x - mu
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        out = xc * rstd * weight.double()
        if bias is not None:
            out = out + bias.double()
        resout = x if save_resout else None
        if not save_stats:
            return out, resout
        return out, resout, None if mu is None else mu[:, 0], rstd[:, 0]

    def ln_bwd(dout, dres_in, resout, mu, rstd, weight, *, is_rms, has_bias,
               x0_dtype, res_dtype, **flags):
        no_flags(flags)
        xhat = (resout if is_rms else resout - mu[:, None]) * rstd[:, None]
        dy = dout.double() * weight.double()
        c1 = (dy * xhat).mean(-1, keepdim=True)
        dres = dy - xhat * c1 - (0 if is_rms else dy.mean(-1, keepdim=True))
        dres = dres * rstd[:, None]
        if dres_in is not None:
            dres = dres + dres_in.double()
        return (dres, None if res_dtype is None else dres,
                (dout.double() * xhat).sum(0),
                dout.double().sum(0) if has_bias else None, None)

    def keep_of(masks, q):
        return masks.keep(q.shape[1], q.device) if masks is not None else None

    def no_dropout(dropout):
        check(not dropout, "the float64 versions take no dropout")

    def attention(q, k, v, *unused, sm_scale, causal, softcap, need_lse,
                  masks=None, dropout_p=0.0, **flags):
        no_dropout(dropout_p)
        out, lse = attention64(q, k, v, sm_scale=sm_scale, causal=causal,
                               softcap=softcap, keep=keep_of(masks, q))
        return out, (lse if need_lse else None)

    def attention_bwd(q, k, v, out, lse, do, *unused, sm_scale, causal,
                      softcap, masks=None, dropout_p=0.0, **flags):
        no_dropout(dropout_p)
        return attention64_grads(q, k, v, do, sm_scale=sm_scale,
                                 causal=causal, softcap=softcap,
                                 keep=keep_of(masks, q))[2:]

    def packed_fwd(q, k, v, *, sm_scale, causal, softcap, need_lse=False,
                   dropout=None):
        no_dropout(dropout)
        out, lse = attention(*(t.transpose(1, 2) for t in (q, k, v)),
                             sm_scale=sm_scale, causal=causal,
                             softcap=softcap, need_lse=True)
        out = out.transpose(1, 2).contiguous()
        return (out, lse) if need_lse else out

    def packed_bwd(q, k, v, out, lse, do, *, sm_scale, causal, softcap,
                   dq=None, dk=None, dv=None, dropout=None):
        no_dropout(dropout)
        grads = [g.transpose(1, 2) for g in attention_bwd(
            *(t.transpose(1, 2) for t in (q, k, v, out)), lse,
            do.transpose(1, 2), sm_scale=sm_scale, causal=causal,
            softcap=softcap)]
        for dst, g in zip((dq, dk, dv), grads):
            if dst is not None:
                dst.copy_(g)
        return tuple(g if dst is None else dst
                     for dst, g in zip((dq, dk, dv), grads))

    def decode(q, k_cache, v_cache, lengths, *, softmax_scale, window_size,
               softcap, kv_batch_idx=None, leftpad_k=None):
        out, _ = attention64(q.transpose(1, 2), k_cache, v_cache,
                             sm_scale=softmax_scale, causal=False,
                             softcap=softcap, lengths=lengths)
        return out.transpose(1, 2)

    patches = [(ln, "ln_fwd", ln_fwd), (ln, "ln_bwd", ln_bwd),
               (iface, "flash_attention_fwd", attention),
               (iface, "flash_attention_bwd", attention_bwd),
               (fh, "fused_heads_fwd", packed_fwd),
               (fh, "fused_heads_bwd", packed_bwd),
               (dec, "flash_decode", decode)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def fp32_gate(what, kern, plain, ref):
    """The fp32 path gate: the kernel path's distance from the float64
    plain path at most twice the fp32 plain path's own, plus 1e-4 of the
    largest |reference|. Prints both distances."""
    kern, plain, ref = (t.double() for t in (kern, plain, ref))
    d_k, d_p = max_err(kern, ref), max_err(plain, ref)
    top = ref.abs().max().item()
    print(f"  {what}: max |kernels - float64| {d_k:.4g}, max |fp32 plain - "
          f"float64| {d_p:.4g}, max |float64| {top:.4g} (gate "
          f"{2 * d_p + 1e-4 * top:.4g})", flush=True)
    check(bool(torch.isfinite(kern).all()), f"{what}: non-finite values")
    check(d_k <= 2 * d_p + 1e-4 * top,
          f"{what}: {d_k} > 2 x {d_p} + 1e-4 x {top}")
    return dict(kernels=d_k, plain=d_p, max_abs=top)


def g_kernel_vs_plain(model, gen):
    """Request G's prefill and one decode step through the kernels, the
    fp32 plain versions and the float64 plain versions (a float64 copy of
    the model), same prompt and token, caches filled by each path's own
    prefill."""
    import copy
    b, prompt, max_length = G_REQUEST
    ids = torch.randint(0, model.config.vocab_size, (b, prompt),
                        generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        model64 = copy.deepcopy(model).double()
        for path in ("kernels", "plain", "float64"):
            m = model64 if path == "float64" else model
            caches = m.allocate_kv_caches(
                b, max_length, torch.float64 if path == "float64" else None)
            ctx = {"kernels": contextlib.nullcontext(),
                   "plain": plain_versions(),
                   "float64": float64_versions()}[path]
            reset_counts()
            with ctx:
                pre, _ = m(ids, kv_caches=caches, seqlen_offset=0)
                tok = (out["kernels"][0][:, -1:].argmax(-1)
                       if "kernels" in out else pre[:, -1:].argmax(-1))
                step, _ = m(tok, kv_caches=caches, seqlen_offset=prompt)
            counts = read_counts()
            if path == "kernels":
                want = {**{k: 0 for k in counters()},
                        "rms_norm_add": 2 * (2 * GPT2_XL["n_layer"] + 1),
                        "flash_fwd_fp32": GPT2_XL["n_layer"],
                        "flash_decode": GPT2_XL["n_layer"]}
                check(counts == want, f"G kernels: launches {counts} != {want}")
            else:
                check(not any(counts.values()),
                      f"the {path} path launched a kernel: {counts}")
            out[path] = (pre, step)
            del caches
        del model64
    torch.cuda.empty_cache()
    return {what: fp32_gate(f"request G {what}, kernels vs float64",
                            out["kernels"][i], out["plain"][i],
                            out["float64"][i])
            for i, what in enumerate(("prefill", "decode step"))}


def g_splitkv(model, gen, seq):
    """flash_attn_with_kvcache with num_splits 3 on request G's fp32 caches
    after its prefill (every layer's cache as decode() leaves it), held to
    flash_decode's output at each layer within 1e-5 of its largest
    output. Returns the split kernel's launches."""
    from xhy_flash_attention_tpu_torch import flash_attn_with_kvcache
    from xhy_flash_attention_tpu_torch.ops.flash_attention import \
        decode_kernel as dk
    b, prompt, max_length = G_REQUEST
    h, d = G_ATTN["h"], G_ATTN["d"]
    with torch.inference_mode():
        caches = model.allocate_kv_caches(b, max_length)
        model(seq[:, :prompt], kv_caches=caches, seqlen_offset=0)
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda")
        lengths = torch.full((b,), prompt, dtype=torch.int32, device="cuda")
        reset_counts()
        worst = 0.0
        for kc, vc in caches:
            got = flash_attn_with_kvcache(
                q, kc.transpose(1, 2), vc.transpose(1, 2),
                cache_seqlens=lengths, num_splits=3)
            want = dk.flash_decode_ref(q, kc, vc, lengths, d ** -0.5)
            worst = max(worst, max_err(got, want)
                        / max(want.abs().max().item(), 1e-30))
        counts = read_counts()
    check(worst <= 1e-5, f"G split-KV: relative err {worst} > 1e-5")
    print(f"  request G caches through flash_attn_with_kvcache(num_splits=3):"
          f" {counts['flash_decode_splitkv']} launches, worst err {worst:.3g}"
          " of max|out| (<= 1e-5)", flush=True)
    return counts["flash_decode_splitkv"]


def gpt2_xl_serving(seed, gen):
    """Phase 18: GPT-2 XL at full width and depth in fp32 from a Hugging
    Face-named state dict (random from the seed) through
    gpt2_config_to_gpt_config and remap_state_dict_hf_gpt2: request G
    through decode() (graph and uncaptured), the kernel path against the
    fp32 and float64 plain paths, then 12 requests through InferenceEngine
    on fp32 pages (chunked prefill, the decode step a graph, tokens equal
    to the uncaptured engine's). Returns the launches by row."""
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, gpt2_config_to_gpt_config, remap_state_dict_hf_gpt2)
    hf = types.SimpleNamespace(**GPT2_XL)
    cfg = gpt2_config_to_gpt_config(hf)
    t0 = time.perf_counter()
    sd = remap_state_dict_hf_gpt2(gpt2_xl_state_dict(seed, hf), cfg)
    t_sd = time.perf_counter() - t0
    model = GPTLMHeadModel(cfg, device="cuda")
    model.load_state_dict(sd)
    del sd
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  GPT-2 XL: {n_params / 1e9:.4f} B parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32; dtype {cfg.dtype}, pdrops "
          f"{cfg.embd_pdrop}/{cfg.resid_pdrop}/{cfg.attn_pdrop} (deterministic"
          f" serving); state dict from the seed in {t_sd:.1f} s, on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    counts, seq, _ = serve(model, gen, "G", G_REQUEST, g_expected_counts)
    launches = {"flash_fwd_fp32 (G prefill)": counts["flash_fwd_fp32"],
                "flash_decode (fp32, G)": counts["flash_decode"]}
    g_kernel_vs_plain(model, gen)
    launches["flash_decode_splitkv (fp32, G)"] = g_splitkv(model, gen, seq)
    counts, st = serve_engine(
        model, torch.float32, seed, _g_engine_requests, G_ENGINE_RUN,
        ("flash_fwd_fp32", "paged_decode (page)"))
    launches["flash_fwd_fp32 (G prefill)"] += counts["flash_fwd_fp32"]
    layers = GPT2_XL["n_layer"]
    launches["paged_decode (page, fp32) G"] = layers * st["decode"]
    launches["paged_decode (page, fp32, sq 512) G"] = layers * st["chunk"]
    del model
    torch.cuda.empty_cache()
    return launches


# ------------------------------- phase 19: T-packed in fp32 (T-packed-fp32)

def doc_loss(trainer, segment_ids):
    """``trainer``'s loss with ``segment_ids`` (b, s), the packed
    documents' ids, passed to the model's forward (every layer's
    attention sees only its document; JAX gpt.py:270)."""
    from xhy_flash_attention_tpu_torch.losses.cross_entropy import (
        cross_entropy_loss)

    def loss_fn(ids, labels):
        logits, _ = trainer.model(ids, segment_ids=segment_ids)
        return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  labels.reshape(-1)).mean()
    return loss_fn


def train_vs_plain_fp64(name, seed, tmp, batch, docs=None):
    """One step's loss and every gradient at depth 2, full width, ``batch``,
    through the kernels, the fp32 plain versions and the float64 plain
    versions (the model in float64), same parameters and batch, under
    fp32_gate. ``docs``: (b, s) segment ids of packed documents passed to
    the model (phase 20), whose step runs the masked fp32 kernels."""
    from xhy_flash_attention_tpu_torch.training import Trainer, load_config
    path, kernels = FP32_RECIPE
    if docs is not None:
        kernels = T_DOC_KERNELS
    cfg = load_config(path)
    tokens = os.path.join(tmp, f"{name}-depth2.bin")
    write_tokens(tokens, seed + 1, batch * (cfg.data.seqlen + 1) * 2)
    cfg = load_config(path, {"data.path": tokens, "data.batch_size": batch,
                             "model.num_hidden_layers": 2,
                             "dtype": "float32"})
    trainer = Trainer(cfg)
    trainer.init_params()
    if docs is not None:
        trainer._loss_fn = doc_loss(trainer, docs[:batch])
    ids, labels = trainer._batch(*next(iter(trainer.data)))
    res = {}
    for path_name in ("kernels", "plain", "float64"):
        reset_counts()
        if path_name == "float64":
            trainer.model.double()
        ctx = {"kernels": contextlib.nullcontext(),
               "plain": plain_versions(),
               "float64": float64_versions()}[path_name]
        with ctx:
            loss, grads = trainer.compute_grads(ids, labels)
        counts = read_counts()
        if path_name == "kernels":
            check(all(counts[k] > 0 for k in kernels),
                  f"{name}: the kernel step missed a kernel: {counts}")
        else:
            check(not any(counts.values()),
                  f"the {path_name} step launched a kernel: {counts}")
        res[path_name] = (loss.double().reshape(1),
                          {n: g.clone() for n, g in grads.items()})
    gates = [fp32_gate(f"{name} depth 2 loss", *(res[p][0] for p in (
        "kernels", "plain", "float64")))]
    worst = None
    for n in res["float64"][1]:
        kern, plain, ref = (res[p][1][n].double()
                            for p in ("kernels", "plain", "float64"))
        d_k, d_p = max_err(kern, ref), max_err(plain, ref)
        top = ref.abs().max().item()
        check(d_k <= 2 * d_p + 1e-4 * top,
              f"{name}: gradient of {n}: {d_k} > 2 x {d_p} + 1e-4 x {top}")
        ratio = d_k / (2 * d_p + 1e-4 * top)
        if worst is None or ratio > worst[0]:
            worst = (ratio, n, d_k, d_p, top)
    print(f"  {name} depth 2, batch {batch}: every gradient of "
          f"{len(res['float64'][1])} within its gate; the closest "
          f"{worst[1]} at {worst[0]:.3g} of it (kernels {worst[2]:.3g}, fp32 "
          f"plain {worst[3]:.3g}, max|float64| {worst[4]:.3g})", flush=True)
    return gates


def train_packed_fp32(seed):
    """Phase 19: `train(gpt2m-flash.yaml, dtype="float32")` at full width
    and depth for FP32_STEPS steps at the largest batch of 32, 16, 8 that
    fits the card (printed as a cut), exact launches of fp32 #5 / #6 and
    the pre-pass, no plain version; then depth 2 against the plain paths.
    Returns the launches by row."""
    name = "T-packed-fp32"
    with tempfile.TemporaryDirectory() as tmp:
        while True:
            try:
                trainer, summary = train_recipe(
                    name, seed, tmp, FP32_RECIPE, {"dtype": "float32"},
                    FP32_STEPS)
                break
            except torch.OutOfMemoryError as exc:
                print(f"  {name}: out of memory at batch "
                      f"{32 // 2 ** BATCH_CUT.get(name, 0)} ({exc!s:.120}); "
                      "halving it (a cut)", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            BATCH_CUT[name] = BATCH_CUT.get(name, 0) + 1
            check(BATCH_CUT[name] <= 2, f"{name}: batch 8 does not fit")
        # phase 10's table for this step: device ms by group, idle share
        train_breakdown(trainer, name)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        train_vs_plain_fp64(name, seed, tmp, summary["batch"])
    torch.cuda.empty_cache()
    n = summary["launches"]
    return {"flash_fwd_fp32 (fused_heads, T-packed)":
            n["flash_fwd (fused_heads)"],
            "fused_heads_bwd (fp32, T-packed)": n["fused_heads_bwd"],
            "flash_bwd_prep (fp32, G shape)": n["flash_bwd_prep"],
            "flash_bwd_dkv_fp32 (G shape)": n["fused_heads_bwd"],
            "flash_bwd_dq_fp32 (G shape)": n["fused_heads_bwd"]}


# ---------------------- phase 20: T-doc-fp32, packed documents in fp32

T_DOC_KERNELS = ("flash_fwd_fp32", "flash_bwd_prep", "flash_bwd_dkv_fp32",
                 "flash_bwd_dq_fp32")
T_DOC_STEPS = 4


def train_doc_fp32(seed):
    """Phase 20: `owt/gpt2m-flash.yaml` in fp32 at full width,
    depth and batch, each row packed with documents whose lengths are drawn
    from ``seed`` in DOC_LENGTHS (FM-doc's draw), cut at the row's end,
    passed as ``segment_ids`` to GPTLMHeadModel's forward (MHA's unpacked
    route: the masked fp32 #1, #2 and #3 on every layer); T_DOC_STEPS AdamW
    steps of the recipe's optimizer through the Trainer, exact launches
    each step and no plain version; ms a step and tokens/s; phase 10's
    breakdown of one more step; then depth 2 against the fp32 and float64
    plain paths (fp32_gate). Returns the launches."""
    from xhy_flash_attention_tpu_torch.training import Trainer, load_config
    name = "T-doc-fp32"
    path = FP32_RECIPE[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(path)
        seqlen, layers = cfg.data.seqlen, cfg.model["num_hidden_layers"]
        batch = cfg.data.batch_size // 2 ** BATCH_CUT.get(
            "T-packed-fp32", 0)
        tokens = os.path.join(tmp, f"{name}.bin")
        write_tokens(tokens, seed + 2, batch * (seqlen + 1) * (T_DOC_STEPS + 4))
        cfg = load_config(path, {"data.path": tokens, "data.batch_size": batch,
                                 "dtype": "float32"})
        docs = doc_rows(gen, batch, seqlen).to(torch.int32)
        lens = torch.unique_consecutive(docs[0], return_counts=True)[1]
        print(f"  {name}: {path} in float32, hidden "
              f"{cfg.model['hidden_size']}, {layers} layers, "
              f"{cfg.model['num_attention_heads']} heads, seqlen {seqlen}, "
              f"batch {batch}, rows packed with documents of "
              f"{DOC_LENGTHS[0]}-{DOC_LENGTHS[1]} tokens (row 0: "
              f"{lens.tolist()}), {T_DOC_STEPS} AdamW steps", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        trainer.init_params()
        trainer._loss_fn = doc_loss(trainer, docs)
        build_s = time.perf_counter() - t0
        want = {k: 0 for k in counters()}
        want.update({"rms_norm_add": 2 * layers + 1, "ln_bwd": 2 * layers + 1,
                     **{k: layers for k in T_DOC_KERNELS}})
        launches = {k: 0 for k in counters()}
        it = iter(trainer.data)
        step_ms, losses = [], []
        with count_plain_calls() as plain:
            for step in range(T_DOC_STEPS):
                ids, labels = trainer._batch(*next(it))
                torch.cuda.synchronize()
                reset_counts()
                t1 = time.perf_counter()
                loss, gnorm = trainer.train_step(ids, labels)
                losses.append(float(loss))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                counts = read_counts()
                check(counts == want, f"{name} step {step + 1}: launches "
                                      f"{counts} != {want}")
                for k_, v_ in counts.items():
                    launches[k_] += v_
                print(f"    step {step + 1}: loss {losses[-1]:.4f}, grad norm "
                      f"{float(gnorm):.4f}, step ms {step_ms[-1]:.2f}, "
                      f"tokens/s {batch * seqlen / step_ms[-1] * 1e3:.1f}",
                      flush=True)
        check(not plain, f"{name}: plain versions ran: {plain}")
        check(all(math.isfinite(x) for x in losses), f"{name}: {losses}")
        check(abs(losses[0] - math.log(50257)) <= 0.5,
              f"{name}: first loss {losses[0]} not within 0.5 of ln(50257)")
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        summary = dict(recipe=name, batch=batch, seqlen=seqlen, layers=layers,
                       model_build_s=build_s, step_ms=step_ms,
                       step_ms_median_of_2_on=steady,
                       tokens_per_s=batch * seqlen / (steady / 1e3),
                       peak_memory_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30, losses=losses,
                       launches={k: v for k, v in launches.items() if v})
        print(f"  {name} summary ({card_line()}): {json.dumps(summary)}",
              flush=True)
        train_breakdown(trainer, name)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        train_vs_plain_fp64(name, seed, tmp, batch, docs=docs)
    torch.cuda.empty_cache()
    return launches


# ------------------------------- phase 21: fp32 with an attention bias

# GPT-2 XL's attention (openai-community/gpt2-xl: 25 heads of 64, 1024
# positions) at batch 4, and Llama-3-8B's (32 heads, 8 kv heads of 128) at
# batch 2, s2048
G_BIAS = dict(b=4, h=25, hk=25, s=1024, d=64)
L_BIAS = dict(b=2, h=32, hk=8, s=2048, d=128)
G_PAD_LENGTHS = (512, 1024)  # G-pad's row lengths, drawn from the seed
PAD_VALUE = -1e4             # an attn_mask's value on padded keys
# label, shape, bias kind, timed: G-pad (b, 1, s, s) -1e4 past each row's
# length; G-alibi (1, h, s, s) ALiBi with BLOOM's slopes; L-shared a
# shared (1, 1, s, s) bias; L-bh a per-head (b, h, s, s) bias (1.07 GB);
# G-bf16bias a bf16 (b, 1, s, s) bias, correctness only
FP32_BIAS_CASES = (("G-pad", G_BIAS, "pad", True),
                   ("G-alibi", G_BIAS, "alibi", True),
                   ("L-shared", L_BIAS, "shared", True),
                   ("L-bh", L_BIAS, "bh", True),
                   ("G-bf16bias", G_BIAS, "bf16", False))
FP32_BIAS_KERNELS = ("flash_fwd_fp32", "flash_bwd_prep", "flash_bwd_dkv_fp32",
                     "flash_bwd_dq_fp32", "flash_bwd_dbias_fp32")
FP32_BIAS_ROWS = (("flash_fwd_fp32", "fwd.py:78"),
                  ("flash_bwd_dkv_fp32", "bwd.py:180"),
                  ("flash_bwd_dq_fp32", "bwd.py:511"),
                  ("flash_bwd_dbias_fp32", "bwd.py:180"))
# float64 references by chunks of (batch, kv-head group) of at most this
# many bytes of float64 scores
FP64_CHUNK_BYTES = 1.1e9


def alibi_slopes(h: int):
    """ALiBi slopes of h heads as BLOOM computes them (transformers'
    build_alibi_tensor): the geometric series of the largest power of two
    below h, then every other term of the next one's."""
    p2 = 2 ** math.floor(math.log2(h))
    base = 2.0 ** (-(2.0 ** -(math.log2(p2) - 3)))
    slopes = [base ** i for i in range(1, p2 + 1)]
    if p2 != h:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * p2) - 3)))
        slopes += [extra ** i for i in range(1, 2 * (h - p2), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device="cuda")


def fp32_bias_tensor(gen, kind, b, h, s):
    """The case's bias (bias.requires_grad is the caller's): see
    FP32_BIAS_CASES."""
    if kind in ("pad", "bf16"):
        lengths = torch.randint(G_PAD_LENGTHS[0], G_PAD_LENGTHS[1] + 1, (b,),
                                generator=gen, device="cuda")
        if kind == "bf16":
            return torch.randn(b, 1, s, s, generator=gen,
                               device="cuda").to(torch.bfloat16)
        keys = torch.arange(s, device="cuda")
        pad = torch.where(keys[None] >= lengths[:, None], PAD_VALUE, 0.0)
        return pad[:, None, None, :].expand(b, 1, s, s).contiguous()
    if kind == "alibi":
        rel = (torch.arange(s, device="cuda")[None]
               - torch.arange(s, device="cuda")[:, None]).float()
        return (alibi_slopes(h)[:, None, None] * rel)[None].contiguous()
    shape = {"shared": (1, 1, s, s), "bh": (b, h, s, s)}[kind]
    return torch.randn(shape, generator=gen, device="cuda")


def fp32_bias_contract(label, ins, got, bias):
    """Phase 18's gate (fp32_contract) for fp32 attention with a bias,
    causal: the kernels' out, LSE, dq, dk, dv and dbias (``got``) against
    float64 within twice the fp32 plain version's error plus 1e-4, all of
    it, by chunks of (batch, kv-head group) (FP64_CHUNK_BYTES): each chunk
    through float64 autograd and through the fp32 plain versions (its own
    forward), dbias summed over the chunks that share it. Returns
    ({what: (err, fp32 plain err)}, {what: kernel err against the fp32
    plain version})."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    q, k, v, do = ins
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    bias4 = fwd.bias_view(bias, b, h, s, s)
    bb, bh = bias4.shape[:2]
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    n_kv = max(1, min(hk, int(FP64_CHUNK_BYTES // (g * s * s * 8))))
    while hk % n_kv:
        n_kv -= 1
    db64 = torch.zeros(bias4.shape, dtype=torch.float64, device="cuda")
    db32 = torch.zeros(bias4.shape, dtype=torch.float32, device="cuda")
    worst = {w: [0.0, 0.0, 0.0] for w in ("out", "lse", "dq", "dk", "dv")}
    for bi in range(b):
        for j in range(0, hk, n_kv):
            hs, ks = slice(j * g, (j + n_kv) * g), slice(j, j + n_kv)
            part = [t[bi:bi + 1, sl] for t, sl in zip(ins, (hs, ks, ks, hs))]
            bsl = bias4[bi:bi + 1] if bb > 1 else bias4
            bsl = bsl[:, hs] if bh > 1 else bsl
            with torch.enable_grad():
                x64 = [t.detach().double().requires_grad_()
                       for t in part[:3] + [bsl]]
                sc = (x64[0] * kw["sm_scale"]) @ x64[1].repeat_interleave(
                    g, 1).transpose(-1, -2) + x64[3]
                sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                               device="cuda").triu(1),
                                    float("-inf"))
                o64 = torch.softmax(sc, -1) @ x64[2].repeat_interleave(g, 1)
                g64 = torch.autograd.grad(o64, x64, part[3].double())
            want = [o64.detach(), torch.logsumexp(sc, -1).detach()] + list(
                g64[:3])
            del sc, o64
            p_out, p_lse = fwd.attention_fwd_ref(*part[:3], need_lse=True,
                                                 bias=bsl, **kw)
            pg = bwd.attention_bwd_ref(*part[:3], p_out, p_lse, part[3],
                                       bias=bsl, **kw)
            plain = [p_out, p_lse] + list(pg[:3])
            mine = [got[0][bi:bi + 1, hs], got[1][bi:bi + 1, hs],
                    got[2][bi:bi + 1, hs], got[3][bi:bi + 1, ks],
                    got[4][bi:bi + 1, ks]]
            for w_, a, p_, ref in zip(worst, mine, plain, want):
                worst[w_][0] = max(worst[w_][0], max_err(a, ref))
                worst[w_][1] = max(worst[w_][1], max_err(p_, ref))
                worst[w_][2] = max(worst[w_][2], max_err(a, p_))
            at = (slice(bi, bi + 1) if bb > 1 else slice(0, 1),
                  hs if bh > 1 else slice(0, 1))
            db64[at] += g64[3]
            db32[at] += pg[3].float()
            del want, plain, g64, pg
    errs = {w_: (e, ep) for w_, (e, ep, _) in worst.items()}
    vs_plain = {w_: e for w_, (_, _, e) in worst.items()}
    dbias = got[5].reshape(bias4.shape)
    errs["dbias"] = (max_err(dbias, db64), max_err(db32, db64))
    vs_plain["dbias"] = max_err(dbias, db32)
    for w_, (e, ep) in errs.items():
        check(e <= 2 * ep + 1e-4, f"fp32 bias {label} {w_}: err vs float64 "
                                  f"{e} > 2 x fp32 plain {ep} + 1e-4")
    return errs, vs_plain


def _sdpa_fp32_bias_ms(q, k, v, do, bias):
    """SDPA in fp32 (TF32 off) with the bias and the causal mask as one
    float attn_mask, enable_gqa (or k and v repeated to every query head
    where no backend takes GQA with a float mask): (forward ms, backward ms
    as fwd + bwd minus fwd, the mask's gradient included). Its own
    yardstick, used nowhere in the port."""
    s, g = q.shape[2], q.shape[1] // k.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    mask = torch.where(causal, bias.detach().float(), float("-inf"))
    mask.requires_grad_()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    gqa = g > 1

    def run():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              enable_gqa=gqa)
    if gqa:
        try:
            with torch.no_grad():
                run()
        except RuntimeError as exc:  # no backend with GQA and a float mask
            print(f"  SDPA fp32 with enable_gqa and a float mask: {exc}; k "
                  "and v repeated to every query head first", flush=True)
            kg, vg = (t.detach().repeat_interleave(g, 1).requires_grad_()
                      for t in (k, v))
            gqa = False
    with torch.no_grad():
        only = time_ms([run], iters=3, warmup=1)
    both = time_ms([lambda: torch.autograd.grad(run(), (qg, kg, vg, mask),
                                                do)], iters=3, warmup=1)
    return only, both - only


def fp32_bias_case(gen, label, shape, kind, timed):
    """Phase 21, one case: fp32 `flash_attention(q, k, v, bias,
    causal=True)` with q, k, v and bias.requires_grad through the autograd
    function (the main path: exact launches of the fp32 forward, pre-pass,
    dK/dV, dQ and dbias kernels, no plain version and no bf16 kernel);
    out, LSE and every gradient under phase 18's gate against float64
    (fp32_bias_contract); the backward's dq, dk, dv and dbias bitwise equal
    over three passes; then, ``timed``, each kernel alone beside its bound
    (3 TF32 products a product at 495 TFLOP/s, the bytes with the bias's
    causal part read and dbias written), the plain versions and SDPA fp32
    with the bias as a float mask. Returns (rows, launches)."""
    from xhy_flash_attention_tpu_torch import flash_attention
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = _dims(shape)
    q, k, v, do = _fp32_inputs(gen, shape)
    bias = fp32_bias_tensor(gen, kind, b, h, s)
    bias_bytes = bias.numel() * bias.element_size()

    def run():
        ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = flash_attention(*ins, causal=True, return_lse=True)
        grads = torch.autograd.grad(out[0], ins, do)
        return [out[0].detach(), out[1]] + list(grads)

    torch.cuda.synchronize()
    reset_counts()
    with count_plain_calls() as plain:
        got = run()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**{key: 0 for key in counters()},
            **{key: 1 for key in FP32_BIAS_KERNELS}}
    check(counts == want, f"fp32 bias {label}: launches {counts} != {want}")
    check(not plain, f"fp32 bias {label}: plain versions ran: {plain}")
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"fp32 bias {label}: non-finite output or gradient")
    check(got[0].dtype == torch.float32 and got[5].shape == bias.shape
          and got[5].dtype == bias.dtype,
          f"fp32 bias {label}: out {got[0].dtype}, dbias "
          f"{tuple(got[5].shape)} {got[5].dtype}")
    errs, vs_plain = fp32_bias_contract(label, (q, k, v, do), got, bias)
    torch.cuda.empty_cache()
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = got[0], got[1]
    first = None
    for _ in range(3):
        grads = bwd.flash_attention_bwd(q, k, v, out, lse, do, bias, **kw)
        if first is None:
            first = grads
        check(all(torch.equal(a, c) for a, c in zip(first, grads)),
              f"fp32 bias {label}: dq, dk, dv or dbias differ pass to pass")
    del first, grads
    print(f"  fp32 bias {label}: b{b} h{h} hk{hk} s{s} d{d} causal, bias "
          f"{tuple(bias.shape)} {str(bias.dtype)[6:]} "
          f"({bias_bytes / 1e9:.4g} GB); vs float64 (all of it, by "
          "(batch, kv-group) chunks): "
          + ", ".join(f"{w} {e:.3g} <= 2 x fp32 plain {ep:.3g} + 1e-4"
                      for w, (e, ep) in errs.items())
          + "; three backward passes bitwise equal (dq, dk, dv, dbias); "
          f"launches {json.dumps({k_: v_ for k_, v_ in counts.items() if v_})}",
          flush=True)
    if not timed:
        return [], counts
    bias4 = fwd.bias_view(bias, b, h, s, s)
    qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = (qs, k, v, do, lse, delta, dq, dk, dv)
    kw32 = dict(sm_scale=kw["sm_scale"], window=(-1, 0), softcap=0.0,
                bias=bias4)
    runs = {
        "flash_fwd_fp32": lambda: fwd.flash_fwd_fp32(
            q, k, v, sm_scale=kw["sm_scale"], window=(-1, 0), bias=bias4),
        "flash_bwd_dkv_fp32": lambda: bwd.flash_bwd_dkv_fp32(*args, **kw32),
        "flash_bwd_dq_fp32": lambda: bwd.flash_bwd_dq_fp32(*args, **kw32),
        "flash_bwd_dbias_fp32": lambda: bwd.flash_bwd_dbias_fp32(
            qs, k, v, do, lse, delta, bias4, causal=True, softcap=0.0)}
    ms = {name: time_ms([fn], iters=10) for name, fn in runs.items()}
    plain_fwd = time_ms([lambda: fwd.attention_fwd_ref(
        q, k, v, need_lse=True, bias=bias4, **kw)], iters=2, warmup=1)
    plain_bwd = time_ms([lambda: bwd.attention_bwd_ref(
        q, k, v, out, lse, do, bias=bias4, **kw)], iters=2, warmup=1)
    torch.cuda.empty_cache()
    lib_fwd, lib_bwd = _sdpa_fp32_bias_ms(q, k, v, do, bias)
    torch.cuda.empty_cache()
    pair = 2.0 * b * h * s * s * d / 2  # one causal s x s x d product
    io = 4.0 * b * s * d * (2 * h + 2 * hk)  # q, do | out, k, v (fp32)
    stats = 2 * 4.0 * b * h * s  # lse, delta
    seen = bias_bytes * (s + 1) / (2 * s)  # the causal part of the bias
    work = {"flash_fwd_fp32": (2, io + 4.0 * b * h * s + seen),
            "flash_bwd_dkv_fp32": (4, io + stats + 2 * 4.0 * b * s * hk * d
                                   + seen),
            "flash_bwd_dq_fp32": (3, io + stats + 4.0 * b * s * h * d + seen),
            "flash_bwd_dbias_fp32": (2, io + stats + seen + bias_bytes)}
    errors = {"flash_fwd_fp32": max(vs_plain["out"], vs_plain["lse"]),
              "flash_bwd_dkv_fp32": max(vs_plain["dk"], vs_plain["dv"]),
              "flash_bwd_dq_fp32": vs_plain["dq"],
              "flash_bwd_dbias_fp32": vs_plain["dbias"]}
    rows = []
    for name, where in FP32_BIAS_ROWS:
        n_mm, nbytes = work[name]
        bms, by = fp32_bound(n_mm * pair, nbytes)
        row = dict(
            name=f"{name} (bias {label})", route="cuda",
            source="xhy_flash_attention_tpu_torch/csrc/flash_fp32.cu",
            replaces=f"xhy_flash_attention_tpu/ops/flash_attention/{where}",
            kernel=name, launches=counts[name], max_abs_err=errors[name],
            ms=ms[name],
            plain_ms=plain_fwd if name == "flash_fwd_fp32" else plain_bwd,
            bound_ms=bms, bound_by=by,
            library_ms=lib_fwd if name == "flash_fwd_fp32" else lib_bwd)
        report(row, f"max_abs_err against the fp32 plain version; b{b} h{h} "
                    f"hk{hk} s{s} d{d} causal, bias {tuple(bias.shape)} fp32 "
                    f"({bias_bytes / 1e9:.4g} GB, {seen / 1e9:.4g} GB of it "
                    f"causal), {n_mm} products (3 TF32 each), bytes "
                    f"{nbytes:.4g}; "
                    + ("plain_ms: the plain forward; library_ms: SDPA fp32 "
                       "with the bias and the causal mask as a float mask"
                       if name == "flash_fwd_fp32" else
                       "plain_ms: the plain backward, library_ms: SDPA fp32's "
                       "backward with the mask's gradient, both whole"))
        rows.append(row)
    whole = sum(ms[n] for n in ms if n != "flash_fwd_fp32")
    print(f"  fp32 bias {label}: forward {ms['flash_fwd_fp32']:.4f} ms (SDPA "
          f"fp32 {lib_fwd:.4f}); backward kernels dK/dV + dQ + dbias "
          f"{whole:.4f} ms (SDPA fp32's backward {lib_bwd:.4f})", flush=True)
    return rows, counts


def fp32_bridge_on_card(gen):
    """Phase 21's end: `capi_bridge.attn_fwd` and `attn_bwd` with G-pad's
    attn_mask on float32 numpy arrays (b, s, h, d) on the card: exact
    launches of the five fp32 kernels, phase 18's gate against float64
    (fp32_bias_contract), three attn_bwd calls bitwise equal."""
    import numpy as np
    from xhy_flash_attention_tpu_torch import capi_bridge
    b, h, hk, s, d = _dims(G_BIAS)
    q, k, v, do = (t.transpose(1, 2).contiguous()
                   for t in _fp32_inputs(gen, G_BIAS))  # (b, s, heads, d)
    mask = fp32_bias_tensor(gen, "pad", b, h, s)
    host = [t.cpu().numpy() for t in (q, k, v, do, mask)]
    reset_counts()
    out, lse = capi_bridge.attn_fwd(*host[:3], host[4], None, 0.0, 0, 0.0, 1,
                                    -1, -1, 0.0)
    bwds = [capi_bridge.attn_bwd(host[3], *host[:3], out, lse, host[4], None,
                                 0.0, 0, 0.0, 1, -1, -1, 0.0)
            for _ in range(3)]
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**{key: 0 for key in counters()},
            **{key: 1 for key in FP32_BIAS_KERNELS}}
    want.update({key: 3 for key in FP32_BIAS_KERNELS[1:]})
    check(counts == want, f"fp32 capi_bridge: launches {counts} != {want}")
    check(all(all(np.array_equal(a, c) for a, c in zip(bwds[0], other))
              for other in bwds[1:]),
          "fp32 capi_bridge: attn_bwd differs call to call")
    dq, dk, dv, dbias = bwds[0]
    check(out.dtype == np.float32 and dbias.dtype == np.float32
          and dbias.shape == (b, 1, s, s),
          f"fp32 capi_bridge: out {out.dtype}, dbias {dbias.dtype} "
          f"{dbias.shape}")
    to = lambda a, bshd=True: (  # noqa: E731
        torch.from_numpy(a).cuda().transpose(1, 2) if bshd
        else torch.from_numpy(a).cuda())
    got = [to(out), to(lse, False), to(dq), to(dk), to(dv), to(dbias, False)]
    errs, _ = fp32_bias_contract("capi_bridge", [t.transpose(1, 2) for t in
                                                 (q, k, v, do)], got, mask)
    print(f"  fp32 capi_bridge on the card: attn_fwd + attn_bwd (three calls, "
          f"bitwise equal) with an attn_mask (b{b} h{h} s{s} d{d} causal, "
          f"mask {tuple(mask.shape)} fp32, numpy float32): "
          + ", ".join(f"{w} {e:.3g} <= 2 x fp32 plain {ep:.3g} + 1e-4"
                      for w, (e, ep) in errs.items())
          + f"; launches {json.dumps({k_: v_ for k_, v_ in counts.items() if v_})}",
          flush=True)


def fp32_bias_entries(gen):
    """Phase 21: every fp32 bias case, then the C-API bridge. Returns the
    rows and each kernel's launches on this path."""
    rows, launches = [], {}
    for label, shape, kind, timed in FP32_BIAS_CASES:
        case_rows, counts = fp32_bias_case(gen, label, shape, kind, timed)
        for key in FP32_BIAS_KERNELS:
            launches[key] = launches.get(key, 0) + counts[key]
        for row in case_rows:
            row["launches"] = counts[row["kernel"]]
        rows += case_rows
        torch.cuda.empty_cache()
    fp32_bridge_on_card(gen)
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------- phase 22

DROP_P = 0.1  # gpt2-medium's attn_pdrop (Hugging Face config.json)
DROP_SEED = 1234
# openai-community/gpt2-medium config.json widths; its embd_pdrop and
# resid_pdrop (0.1) are cut to 0 in phase 22: the JAX model raises on them
# with deterministic=False (its GPTModel hands no seed to the blocks)
GPT2_MEDIUM = dict(vocab_size=50257, n_embd=1024, n_layer=24, n_head=16,
                   n_positions=1024, layer_norm_epsilon=1e-5, attn_pdrop=0.1,
                   embd_pdrop=0.1, resid_pdrop=0.1)
DROPOUT_STEPS = 3
STEP_MS = {}  # phase -> its training steps' ms (host clock), this run
INT32_PER_CLOCK = 64  # int32 lanes a clock per SM (compute capability 9.0)
# Integer instructions the kernels spend on one hashed element
# (csrc/common.cuh dropout_each / dropout_keep): the add of the element's
# constant, three shift-xor pairs, two multiplies, the compare, the select.
HASH_OPS = 11


def int_floor_ms(elements: float) -> float:
    """The least time the card's integer units take for HASH_OPS
    instructions per hashed element: INT32_PER_CLOCK a clock per SM at the
    clock of the bf16 peak."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return elements * HASH_OPS / (INT32_PER_CLOCK * sms * TENSOR_CLOCK_HZ) * 1e3


def _drop(p, seed):
    from xhy_flash_attention_tpu_torch.ops.flash_attention.common import \
        Dropout
    return Dropout(p, seed & 0xFFFFFFFF)


def _dkw(drop):
    """The entries' dropout keywords of a Dropout."""
    return dict(dropout_p=drop.p, dropout_seed=drop.seed)


def dropout_launches():
    """The dropout instantiations' launches so far, by kernel and
    instantiation: "fwd d64", "dkv d128", "dq d64 masked", ..."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    n = {f"fwd {k}": v for k, v in
         fwd.launch_flash_fwd.dropout_launches.items() if v}
    n.update((k, v) for k, v in bwd.launch_flash_bwd.dropout_launches.items()
             if v)
    return n


def reset_dropout_launches():
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    fwd.launch_flash_fwd.dropout_launches.clear()
    bwd.launch_flash_bwd.dropout_launches.clear()


def _each(inst, n=1):
    """The launch counts of n forwards and backwards of one dropout
    instantiation (fwd.dropout_instance's name)."""
    return {f"{k} {inst}": n for k in ("fwd", "dkv", "dq")}


class _BatchRow:
    """Batch row ``i`` of ``drop``'s keep masks, for the plain versions run
    on that row alone: the rows of drop.keep(b, ...)[i], made for one row
    so that the masks of a whole batch are never held."""

    def __init__(self, drop, i):
        self.p, self.scale, self.seed, self.i = drop.p, drop.scale, drop.seed, i

    def keep(self, b, h, sq, sk, device=None):
        from xhy_flash_attention_tpu_torch.ops.flash_attention.common import \
            dropout_keep_mask
        salt = self.i * h + torch.arange(h, device=device)
        return dropout_keep_mask(
            self.seed, salt[None, :, None, None],
            torch.arange(sq, device=device)[:, None],
            torch.arange(sk, device=device)[None, :], self.p)


def dropout_mask_probe(device="cuda"):
    """The keep mask that each dropout kernel applies, read back bit for
    bit against `common.dropout_keep_mask` (b2 h4 hk2 sq320 sk512, d 64
    and 128, the dense instantiations without a mask and the masked ones
    under a block mask of ones and causal (sq != sk: the bottom-right
    diagonal), seeds 0, 77 and -3, p 0.1, 0.5, 0.9). q = 0 makes P uniform
    over each row's visible keys, so that:
      #1: V one-hot on a window of d keys (key w0 + j carries column j, the
          other keys' rows 0): out[r, j] != 0 exactly where (r, w0 + j) is
          kept and visible;
      #2: dO one-hot on a window of d rows: dV[c, j] != 0 exactly where
          (r0 + j, c) is kept and visible;
      #3: K one-hot on a window of d keys, V and dO the first unit vector
          (dP = 1): dS = P (kept ? 1 / (1 - p) - delta : -delta), delta
          between the two, so dQ[r, j] > 0 exactly where (r, w0 + j) is
          kept and visible.
    The windows cover every key (and row) of the call. On a CPU device the
    plain versions run (a rehearsal of the probe itself)."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, sq, sk = 2, 4, 2, 320, 512
    z = dict(dtype=torch.bfloat16, device=device)
    n_calls = 0
    for d in (64, 128):
        eye = torch.eye(d, **z)
        for masked in (False, True):
            flags = dict(block_mask=(torch.ones(1, 1, 3, 4, dtype=torch.int32,
                                                device=device), 128, 128)
                         ) if masked else {}
            causal = masked
            rows = torch.arange(sq, device=device)[:, None]
            cols = torch.arange(sk, device=device)[None, :]
            vis = (cols <= rows + (sk - sq)) if causal else \
                torch.ones(sq, sk, dtype=torch.bool, device=device)
            kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0, **flags)
            for seed in (0, 77, -3):
                for p in (0.1, 0.5, 0.9):
                    drop = _drop(p, seed)
                    keep = drop.keep(b, h, sq, sk, device) & vis
                    q = torch.zeros(b, h, sq, d, **z)
                    zk = torch.zeros(b, hk, sk, d, **z)
                    for w0 in range(0, sk, d):  # #1
                        v = torch.zeros(b, hk, sk, d, **z)
                        v[:, :, w0:w0 + d] = eye
                        out, _ = fwd.flash_attention_fwd(
                            q, zk, v, need_lse=False, **_dkw(drop), **kw)
                        check(torch.equal(out != 0, keep[..., w0:w0 + d]),
                              f"#1's keep mask (d {d}, masked {masked}, "
                              f"seed {seed}, p {p}, keys {w0}+)")
                        n_calls += 1
                    v = torch.zeros(b, hk, sk, d, **z)
                    v[..., 0] = 1
                    out, lse = fwd.flash_attention_fwd(
                        q, zk, v, need_lse=True, **_dkw(drop), **kw)
                    for r0 in range(0, sq, d):  # #2
                        do = torch.zeros(b, h, sq, d, **z)
                        n = min(d, sq - r0)
                        do[:, :, r0:r0 + n] = eye[:n]
                        # dV sums the group's heads: per head, one at a time
                        for hh in range(h):
                            one = torch.zeros_like(do)
                            one[:, hh] = do[:, hh]
                            _, _, dv = bwd.flash_attention_bwd(
                                q, zk, v, out, lse, one, **_dkw(drop), **kw)
                            got = dv[:, hh // (h // hk), :, :n] != 0
                            want = keep[:, hh, r0:r0 + n].transpose(-1, -2)
                            check(torch.equal(got, want),
                                  f"#2's keep mask (d {d}, masked {masked}, "
                                  f"seed {seed}, p {p}, rows {r0}+, head "
                                  f"{hh})")
                            n_calls += 1
                    do = torch.zeros(b, h, sq, d, **z)
                    do[..., 0] = 1
                    for w0 in range(0, sk, d):  # #3
                        k1 = torch.zeros(b, hk, sk, d, **z)
                        k1[:, :, w0:w0 + d] = eye
                        dq, _, _ = bwd.flash_attention_bwd(
                            q, k1, v, out, lse, do, **_dkw(drop), **kw)
                        check(torch.equal(dq > 0, keep[..., w0:w0 + d]),
                              f"#3's keep mask (d {d}, masked {masked}, "
                              f"seed {seed}, p {p}, keys {w0}+)")
                        n_calls += 1
                    torch.cuda.synchronize()
    drop = _drop(DROP_P, DROP_SEED)
    whole = drop.keep(b, h, sq, sk, device)
    check(all(torch.equal(_BatchRow(drop, i).keep(1, h, sq, sk, device),
                          whole[i:i + 1]) for i in range(b)),
          "the plain versions' batch rows are not the batch's masks")
    print(f"  keep masks read back from #1, #2 and #3: bitwise equal to "
          f"dropout_keep_mask in {n_calls} readings (b{b} h{h} hk{hk} "
          f"sq{sq} sk{sk}; d 64 and 128; dense and masked (block mask, "
          "causal); seeds 0, 77, -3; p 0.1, 0.5, 0.9)", flush=True)


def _row_mask(keep, i):
    """Batch row i of a dense keep mask (b|1, hm|1, sq, sk), or None."""
    if keep is None:
        return None
    return keep[i:i + 1] if keep.shape[0] > 1 else keep


def plain_dropout_fwd(qt, kt, vt, drop, kw, keep=None):
    """The plain forward with dropout a batch row at a time (each row with
    its own masks, _BatchRow), under the dense keep mask ``keep`` (or
    none): out, lse."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fwd
    parts = [fwd.attention_fwd_ref(
        qt[i:i + 1], kt[i:i + 1], vt[i:i + 1], need_lse=True,
        mask=_row_mask(keep, i),
        dropout=_BatchRow(drop, i), **kw) for i in range(qt.shape[0])]
    return [torch.cat(t) for t in zip(*parts)]


def plain_dropout_bwd(qt, kt, vt, out, lse, dot, drop, kw, keep=None):
    """The plain backward with dropout a batch row at a time: dq, dk, dv."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd
    parts = [bwd.attention_bwd_ref(
        qt[i:i + 1], kt[i:i + 1], vt[i:i + 1], out[i:i + 1], lse[i:i + 1],
        dot[i:i + 1], mask=_row_mask(keep, i),
        dropout=_BatchRow(drop, i), **kw) for i in range(qt.shape[0])]
    return [torch.cat(t) for t in zip(*parts)]


def _dropout_contract(outs, q, k, v, do, drop, causal=True):
    """The repository's contract with dropout, on batch row 0: out (and the
    gradients, with ``do``) within twice the bf16 reorder-ops baseline's
    error of the fp32 `attention_ref` under the same keep mask. ``outs``
    (b, s, h, d) tensors: out, or dq, dk, dv. Returns the worst (error,
    baseline error) pair."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention.reference import \
        attention_ref
    sq, h, sk = q.shape[1], q.shape[2], k.shape[1]
    keep = drop.keep(1, h, sq, sk, "cuda")

    def ref(upcast, reorder):
        ins = [t[:1].detach().clone().requires_grad_(do is not None)
               for t in (q, k, v)]
        out, _ = attention_ref(*ins, causal=causal, upcast=upcast,
                               reorder_ops=reorder, dropout_p=drop.p,
                               dropout_mask=keep)
        if do is None:
            return [out.detach()]
        return torch.autograd.grad(out, ins, do[:1])
    want, low = ref(True, False), ref(False, True)
    worst = (0.0, 0.0)
    for g, w, lo in zip(outs, want, low):
        e, e_lp = max_err(g[:1], w), max_err(lo, w)
        check(e <= 2 * e_lp + (1e-3 if do is not None else 1e-4),
              f"dropout: err vs fp32 ref {e} > 2 x bf16 baseline {e_lp}")
        worst = max(worst, (e, e_lp))
    return worst


def _sdpa_dropout_ms(qt, kt, vt, dot, keep=None):
    """SDPA with dropout_p=DROP_P (other random bits, the same work),
    causal or under the dense keep mask ``keep``: (forward ms, backward ms
    as fwd + bwd minus fwd)."""
    g = qt.shape[1] // kt.shape[1]  # GQA: k and v repeated first, untimed
    qg, kg, vg = (t.detach().repeat_interleave(n, 1).requires_grad_()
                  for t, n in ((qt, 1), (kt, g), (vt, g)))

    def run():
        return F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=keep, is_causal=keep is None,
            dropout_p=DROP_P)
    with torch.no_grad():
        only = time_ms([run], iters=10)
    both = time_ms([lambda: torch.autograd.grad(run(), (qg, kg, vg), dot)],
                   iters=10)
    return only, both - only


def dropout_kernels(gen, label, shape):
    """#1, #2 and #3 with dropout (p 0.1) through flash_attention_fwd /
    flash_attention_bwd at ``shape`` (causal): against their plain versions
    (4 bf16 units of the largest gradient; out by row_excess), the 2x
    contract under the same keep mask on batch row 0, three backward passes
    bitwise equal, the launches of the dropout instantiations exact; rows
    timed beside the same kernels without dropout, the bound (the dense
    products at the bf16 rate, the bytes, and the integer floor of the
    hash, the largest of the three) and SDPA with dropout_p 0.1."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    drop = _drop(DROP_P, DROP_SEED)
    (q, k, v, do), (qt, kt, vt, dot, _, _), kw = _bwd_inputs(gen, shape)
    reset_dropout_launches()
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True,
                                       **_dkw(drop), **kw)
    grads = bwd.flash_attention_bwd(qt, kt, vt, out, lse, dot, **_dkw(drop),
                                    **kw)
    torch.cuda.synchronize()
    inst = fwd.dropout_instance(d, False)
    check(dropout_launches() == _each(inst),
          f"dropout {label}: launches {dropout_launches()} != {_each(inst)}")
    p_out, p_lse = plain_dropout_fwd(qt, kt, vt, drop, kw)
    err_out, exc = max_err(out, p_out), row_excess(out, p_out)
    err_lse = max_err(lse, p_lse)
    check(exc <= 1 and err_lse <= 1e-3,
          f"dropout {label}: out row excess {exc}, lse err {err_lse}")
    del p_out, p_lse
    want = plain_dropout_bwd(qt, kt, vt, out, lse, dot, drop, kw)
    err_dq = max_err(grads[0], want[0])
    err_dkv = max(max_err(grads[1], want[1]), max_err(grads[2], want[2]))
    tol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(max(err_dq, err_dkv) <= tol,
          f"dropout {label}: grads vs plain {err_dq}, {err_dkv} > {tol}")
    del want
    e_o, lp_o = _dropout_contract([out.transpose(1, 2)], q, k, v, None, drop)
    e_g, lp_g = _dropout_contract([g.transpose(1, 2) for g in grads], q, k,
                                  v, do, drop)
    _bitwise_three_passes(lambda: bwd.flash_attention_bwd(
        qt, kt, vt, out, lse, dot, **_dkw(drop), **kw),
        f"attention backward with dropout at {label}")
    qs, delta = bwd.flash_bwd_prep(qt, out, dot, sm_scale=kw["sm_scale"])
    dq, dk, dv = (torch.empty_like(t) for t in grads)
    args = (qs, kt, vt, dot, lse, delta, dq, dk, dv)
    del grads
    pair = 2.0 * b * h * s * s * d / 2  # one causal s x s x d product
    pairs = b * h * s * (s + 1) / 2.0   # visible (row, key) pairs
    io = 2.0 * b * s * d * (2 * h + 2 * hk)
    stats = 2 * 4.0 * b * h * s
    lib_fwd, lib_bwd = _sdpa_dropout_ms(qt, kt, vt, dot)
    plain_fwd = time_ms([lambda: plain_dropout_fwd(qt, kt, vt, drop, kw)],
                        iters=2, warmup=1)
    plain_bwd = time_ms([lambda: plain_dropout_bwd(
        qt, kt, vt, out, lse, dot, drop, kw)], iters=2, warmup=1)
    src_b = "xhy_flash_attention_tpu_torch/csrc/flash_bwd.cu"
    base = "xhy_flash_attention_tpu/ops/flash_attention/"
    rows = []
    for name, src, rep, n_mm, nbytes, err, plain, lib, run, run_nd in (
            ("flash_fwd", "xhy_flash_attention_tpu_torch/csrc/flash_fwd.cu",
             base + "fwd.py:78", 2, io, err_out, plain_fwd, lib_fwd,
             lambda: fwd.flash_attention_fwd(qt, kt, vt, need_lse=True,
                                             **_dkw(drop), **kw),
             lambda: fwd.flash_attention_fwd(qt, kt, vt, need_lse=True,
                                             **kw)),
            ("flash_bwd_dkv", src_b, base + "bwd.py:180", 4,
             io + stats + 2 * 2.0 * b * s * hk * d, err_dkv, plain_bwd,
             lib_bwd, lambda: bwd.flash_bwd_dkv(*args, dropout=drop, **kw),
             lambda: bwd.flash_bwd_dkv(*args, **kw)),
            ("flash_bwd_dq", src_b, base + "bwd.py:511", 3,
             io + stats + 2.0 * b * s * h * d, err_dq, plain_bwd, lib_bwd,
             lambda: bwd.flash_bwd_dq(*args, dropout=drop, **kw),
             lambda: bwd.flash_bwd_dq(*args, **kw))):
        t_ops, _ = bound(n_mm * pair, PEAK_BF16_FLOPS, 0.0)
        t_int = int_floor_ms(pairs)
        bms, by = bound(n_mm * pair, PEAK_BF16_FLOPS, nbytes)
        bms = max(bms, t_int)
        by = by if bms > t_int else "operations"
        ms = time_ms([run], iters=10)
        ms_nd = time_ms([run_nd], iters=10)
        row = dict(
            name=f"{name} (dropout, {label})", route="cuda", source=src,
            replaces=rep, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=lib,
            instance=f"{name.split('_')[-1]} {inst}")
        report(row, f"vs its plain version ({'row excess %.3g <= 1' % exc if name == 'flash_fwd' else 'tol %.3g = 4 bf16 ulp' % tol}); "
                    f"vs fp32 attention_ref under the same keep mask, out "
                    f"{e_o:.3g} <= 2 x {lp_o:.3g}, grads {e_g:.3g} <= 2 x "
                    f"{lp_g:.3g}; b{b} h{h} hk{hk} s{s} d{d} causal, p "
                    f"{DROP_P}; {n_mm} products {t_ops:.4f} ms, integer "
                    f"floor {t_int:.4f} ms ({HASH_OPS} ops x {pairs:.4g} "
                    f"hashed pairs), bytes {nbytes:.4g}; without dropout "
                    f"{ms_nd:.4f} ms (x{ms / ms_nd:.3f} with it); plain_ms "
                    f"and library_ms (SDPA, dropout_p {DROP_P}) of the "
                    f"whole {'forward' if name == 'flash_fwd' else 'backward'}")
        rows.append(row)
    return rows


def dropout_packed(gen):
    """#5 and #6 with dropout at T-packed's shape (the packed dqkv entry):
    against the plain versions, the contract, three passes bitwise equal,
    each timed beside itself without dropout and SDPA with dropout."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import fused_heads as fh
    c = T_PACKED
    b, h, hk, s, d = (c[k] for k in ("b", "h", "hk", "s", "d"))
    drop = _drop(DROP_P, DROP_SEED + 1)
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                      device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    q, k, v = fh._split(qkv, h, hk, d)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    reset_dropout_launches()
    out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, dropout=drop, **kw)
    dqkv = torch.empty_like(qkv)
    dst = dict(zip(("dq", "dk", "dv"), fh._split(dqkv, h, hk, d)))
    grads = fh.fused_heads_bwd(q, k, v, out, lse, do, dropout=drop, **kw,
                               **dst)
    torch.cuda.synchronize()
    check(dropout_launches() == _each("d64"),
          f"dropout T-packed: launches {dropout_launches()}")
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    p_out, _ = plain_dropout_fwd(qt, kt, vt, drop, kw)
    exc = row_excess(out, p_out.transpose(1, 2))
    err_out = max_err(out, p_out.transpose(1, 2))
    del p_out
    want = [t.transpose(1, 2) for t in plain_dropout_bwd(
        qt, kt, vt, out.transpose(1, 2), lse, dot, drop, kw)]
    err = max(max_err(g, w) for g, w in zip(grads, want))
    tol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(exc <= 1 and err <= tol,
          f"dropout T-packed: out row excess {exc}, grads err {err} > {tol}")
    del want
    e_o, lp_o = _dropout_contract([out], q, k, v, None, drop)
    e_g, lp_g = _dropout_contract(grads, q, k, v, do, drop)
    _bitwise_three_passes(lambda: [t.clone() for t in fh.fused_heads_bwd(
        q, k, v, out, lse, do, dropout=drop, **kw, **dst)],
        "packed backward with dropout at T-packed")
    pair = 2.0 * b * h * s * s * d / 2
    pairs = b * h * s * (s + 1) / 2.0
    io = 2.0 * b * s * d * (2 * h + 2 * hk)
    lib_fwd, lib_bwd = _sdpa_dropout_ms(qt, kt, vt, dot)
    rows = []
    for name, src, rep, n_mm, n_hash, nbytes, e, plain, lib, run, run_nd in (
            ("flash_fwd (fused_heads, dropout, T-packed)", "flash_fwd.cu",
             "fused_heads.py:59",
             2, 1, io, err_out,
             time_ms([lambda: fh.fused_heads_fwd_ref(
                 q, k, v, dropout=drop, **kw)], iters=2, warmup=1), lib_fwd,
             lambda: fh.fused_heads_fwd(q, k, v, need_lse=True, dropout=drop,
                                        **kw),
             lambda: fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)),
            ("fused_heads_bwd (dropout, T-packed)", "flash_bwd.cu",
             "fused_heads.py:105", 5, 2,
             io + 2 * 4.0 * b * h * s + 2.0 * b * s * d * (h + 2 * hk), err,
             time_ms([lambda: fh.fused_heads_bwd_ref(
                 q, k, v, out, lse, do, dropout=drop, **kw)], iters=2,
                 warmup=1), lib_bwd,
             lambda: fh.fused_heads_bwd(q, k, v, out, lse, do, dropout=drop,
                                        **kw, **dst),
             lambda: fh.fused_heads_bwd(q, k, v, out, lse, do, **kw,
                                        **dst))):
        t_int = int_floor_ms(n_hash * pairs)
        bms, by = bound(n_mm * pair, PEAK_BF16_FLOPS, nbytes)
        if t_int > bms:
            bms, by = t_int, "operations"
        ms = time_ms([run], iters=10)
        ms_nd = time_ms([run_nd], iters=10)
        row = dict(
            name=name, route="cuda",
            source=f"xhy_flash_attention_tpu_torch/csrc/{src}",
            replaces=f"xhy_flash_attention_tpu/ops/flash_attention/{rep}",
            max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            library_ms=lib, instance="fwd d64" if n_hash == 1 else None)
        report(row, f"out row excess {exc:.3g} <= 1, grads tol {tol:.3g}; "
                    f"vs fp32 attention_ref under the same keep mask, out "
                    f"{e_o:.3g} <= 2 x {lp_o:.3g}, grads {e_g:.3g} <= 2 x "
                    f"{lp_g:.3g}; packed b{b} s{s} h{h} d{d} causal, p "
                    f"{DROP_P}; integer floor {t_int:.4f} ms; without "
                    f"dropout {ms_nd:.4f} ms (x{ms / ms_nd:.3f} with it); "
                    "the backward's ms includes the pre-pass")
        rows.append(row)
    return rows


def dropout_masked(gen):
    """#1, #2 and #3 with dropout under FM-doc's causal document FlashMask
    (T-long's attention): the masked dropout instantiations against their
    plain versions (a batch row at a time under the dense keep mask; out by
    row_excess, gradients to 4 bf16 units), three backward passes bitwise
    equal, each timed beside itself without dropout; bound over the
    visible pairs (the products at the bf16 rate, the bytes, and the
    integer floor of the hash), library SDPA with the dense mask and
    dropout_p 0.1."""
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    b, h, hk, s, d = (T_LONG[k] for k in ("b", "h", "hk", "s", "d"))
    drop = _drop(DROP_P, DROP_SEED + 2)
    flags = _flags(doc_indices(gen, b, s), causal=True)
    _, (qt, kt, vt, dot, _, _), kw = _bwd_inputs(gen, T_LONG)
    causal, masks = fwd.build_masks(b, h, s, s, True, **flags)
    kw = dict(kw, causal=causal)
    mk = dict(masks=masks, **_dkw(drop))  # the entries'
    lk = dict(masks=masks, dropout=drop)  # the kernels' wrappers
    reset_dropout_launches()
    out, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **mk, **kw)
    grads = bwd.flash_attention_bwd(qt, kt, vt, out, lse, dot, **mk, **kw)
    torch.cuda.synchronize()
    check(dropout_launches() == _each("d64 masked"),
          f"dropout FM-doc: launches {dropout_launches()}")
    keep = masks.keep(h, qt.device)
    p_out, _ = plain_dropout_fwd(qt, kt, vt, drop, kw, keep)
    exc, err_out = row_excess(out, p_out), max_err(out, p_out)
    del p_out
    want = plain_dropout_bwd(qt, kt, vt, out, lse, dot, drop, kw, keep)
    err_dq = max_err(grads[0], want[0])
    err_dkv = max(max_err(grads[1], want[1]), max_err(grads[2], want[2]))
    tol = 4 * BF16_ULP * max(w.float().abs().max().item() for w in want)
    check(exc <= 1 and max(err_dq, err_dkv) <= tol,
          f"dropout FM-doc: out row excess {exc}, grads {err_dq}, "
          f"{err_dkv} > {tol}")
    del want
    _bitwise_three_passes(lambda: bwd.flash_attention_bwd(
        qt, kt, vt, out, lse, dot, **mk, **kw),
        "masked attention backward with dropout at FM-doc")
    qs, delta = bwd.flash_bwd_prep(qt, out, dot, sm_scale=kw["sm_scale"])
    args = (qs, kt, vt, dot, lse, delta,
            *(torch.empty_like(t) for t in grads))
    del grads
    full = _keep(flags, True, h, s, s)
    pairs = visible_pairs(full, b, h)
    lib_fwd, lib_bwd = _sdpa_dropout_ms(qt, kt, vt, dot, full)
    del full
    io = 2.0 * b * s * d * (2 * h + 2 * hk)
    stats = 2 * 4.0 * b * h * s
    plain_fwd = time_ms([lambda: plain_dropout_fwd(qt, kt, vt, drop, kw,
                                                   keep)], iters=2, warmup=1)
    plain_bwd = time_ms([lambda: plain_dropout_bwd(
        qt, kt, vt, out, lse, dot, drop, kw, keep)], iters=2, warmup=1)
    base = "xhy_flash_attention_tpu/ops/flash_attention/"
    rows = []
    for name, src, rep, n_mm, nbytes, err, plain, lib, run, run_nd in (
            ("flash_fwd", "flash_fwd.cu", "fwd.py:78", 2, io, err_out,
             plain_fwd, lib_fwd,
             lambda: fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **mk,
                                             **kw),
             lambda: fwd.flash_attention_fwd(qt, kt, vt, need_lse=True,
                                             masks=masks, **kw)),
            ("flash_bwd_dkv", "flash_bwd.cu", "bwd.py:180", 4,
             io + stats + 2 * 2.0 * b * s * hk * d, err_dkv, plain_bwd,
             lib_bwd, lambda: bwd.flash_bwd_dkv(*args, **lk, **kw),
             lambda: bwd.flash_bwd_dkv(*args, masks=masks, **kw)),
            ("flash_bwd_dq", "flash_bwd.cu", "bwd.py:511", 3,
             io + stats + 2.0 * b * s * h * d, err_dq, plain_bwd, lib_bwd,
             lambda: bwd.flash_bwd_dq(*args, **lk, **kw),
             lambda: bwd.flash_bwd_dq(*args, masks=masks, **kw))):
        t_int = int_floor_ms(pairs)
        bms, by = bound(n_mm * 2.0 * pairs * d, PEAK_BF16_FLOPS, nbytes)
        if t_int > bms:
            bms, by = t_int, "operations"
        ms = time_ms([run], iters=10)
        ms_nd = time_ms([run_nd], iters=10)
        row = dict(
            name=f"{name} (dropout, FM-doc)", route="cuda",
            source=f"xhy_flash_attention_tpu_torch/csrc/{src}",
            replaces=base + rep, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=lib,
            instance=f"{name.split('_')[-1]} d64 masked")
        report(row, f"out row excess {exc:.3g} <= 1, grads tol {tol:.3g}; "
                    f"b{b} h{h} s{s} d{d}, causal document FlashMask, "
                    f"visible {pairs / (b * h * s * s):.3f}, p {DROP_P}; "
                    f"integer floor {t_int:.4f} ms; without dropout "
                    f"{ms_nd:.4f} ms (x{ms / ms_nd:.3f} with it); library: "
                    "SDPA with the dense mask and dropout_p 0.1")
        rows.append(row)
    return rows


def gpt2m_dropout_model(seed, layers=None):
    """GPT-2 medium (GPT2_MEDIUM) in bf16 from random weights with
    attn_pdrop 0.1 and the embedding and residual rates cut to 0, and its
    fp32 master parameters (the Trainer's, training/train.py)."""
    import dataclasses
    from xhy_flash_attention_tpu_torch import GPTLMHeadModel
    from xhy_flash_attention_tpu_torch.models.gpt import \
        gpt2_config_to_gpt_config
    cfg = dataclasses.replace(
        gpt2_config_to_gpt_config(types.SimpleNamespace(**GPT2_MEDIUM),
                                  torch.bfloat16),
        embd_pdrop=0.0, resid_pdrop=0.0,
        num_hidden_layers=layers or GPT2_MEDIUM["n_layer"])
    model = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    params = {n: p.detach() if p.dtype == torch.float32 else
              p.detach().float().clone() for n, p in model.named_parameters()}
    return model, params


def dropout_grads(model, ids, labels, seed):
    """Loss and fp32 gradients of one deterministic=False step, each
    layer's dropout seed drawn from a CPU generator seeded ``seed``."""
    from xhy_flash_attention_tpu_torch.losses.cross_entropy import \
        cross_entropy_loss
    for p in model.parameters():
        p.grad = None
    gen = torch.Generator().manual_seed(seed)
    logits, _ = model(ids, deterministic=False, dropout_generator=gen)
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1)).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.float()
                           for n, p in model.named_parameters()}


def train_dropout_gpt2m(seed, gen):
    """GPT-2 medium with attention dropout, trained for DROPOUT_STEPS steps
    of deterministic=False forward, cross-entropy, backward and the port's
    AdamW (gpt2m-flash.yaml's optimizer and schedule) at the recipe's batch
    and seqlen; attention on the packed route (#5 / #6) with the dropout
    instantiations. Gates: exact launches (and of the dropout
    instantiations), no plain version, finite losses, a repeat of step 1
    with the same seeds bitwise equal (loss and every gradient), another
    seed different, and at depth 2 the kernels against the plain versions
    under the same seeds (phase 9's limits). Returns the launches."""
    from xhy_flash_attention_tpu_torch.training import load_config
    from xhy_flash_attention_tpu_torch.training.optim import Optimizer
    rc = load_config(RECIPES["T-packed"][0])
    batch, seqlen = rc.data.batch_size, rc.data.seqlen
    layers = GPT2_MEDIUM["n_layer"]
    vocab = GPT2_MEDIUM["vocab_size"]
    model, params = gpt2m_dropout_model(seed)
    opt = Optimizer(rc.optimizer, rc.scheduler)
    state = opt.init(params)
    toks = torch.randint(0, vocab, (DROPOUT_STEPS, batch, seqlen + 1),
                         generator=gen, device="cuda")

    def sync():
        with torch.no_grad():
            for n, p in model.named_parameters():
                if params[n].data_ptr() != p.data_ptr():
                    p.copy_(params[n])
    print(f"  GPT-2 medium widths (hidden {GPT2_MEDIUM['n_embd']}, {layers} "
          f"layers, {GPT2_MEDIUM['n_head']} heads of 64, vocab {vocab}), "
          f"bf16, random weights; attn_pdrop {DROP_P}, embd_pdrop and "
          f"resid_pdrop cut from 0.1 to 0; batch {batch} x seqlen {seqlen} "
          f"(gpt2m-flash.yaml), {DROPOUT_STEPS} steps, the recipe's AdamW",
          flush=True)
    ids, labels = toks[0, :, :-1], toks[0, :, 1:]
    loss_a, grads_a = dropout_grads(model, ids, labels, DROP_SEED)
    loss_b, grads_b = dropout_grads(model, ids, labels, DROP_SEED)
    same = float(loss_a) == float(loss_b) and all(
        torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    check(same, "GPT-2 medium dropout: a repeat with the same seeds differs")
    dq_name = "transformer.layers.0.mixer.Wqkv.weight"
    del grads_b
    loss_c, grads_c = dropout_grads(model, ids, labels, DROP_SEED + 1)
    check(float(loss_c) != float(loss_a)
          and not torch.equal(grads_c[dq_name], grads_a[dq_name]),
          "GPT-2 medium dropout: another seed gives the same step")
    print(f"  step 1 twice with the same seeds: loss {float(loss_a):.6f} "
          f"both times, every gradient bitwise equal; another seed: loss "
          f"{float(loss_c):.6f}", flush=True)
    del grads_a, grads_c
    want = {k: 0 for k in counters()}
    want.update({"rms_norm_add": 2 * layers + 1, "ln_bwd": 2 * layers + 1,
                 "flash_fwd (fused_heads)": layers, "flash_bwd_prep": layers,
                 "fused_heads_bwd": layers})
    launches = {k: 0 for k in counters()}
    drops = collections.Counter()
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with count_plain_calls() as plain:
        for i in range(DROPOUT_STEPS):
            ids, labels = toks[i, :, :-1], toks[i, :, 1:]
            reset_counts()
            reset_dropout_launches()
            t0 = time.perf_counter()
            loss, grads = dropout_grads(model, ids, labels, DROP_SEED + 10 + i)
            gnorm = opt.update(grads, state, params)
            sync()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            STEP_MS["T-drop"] = list(step_ms)
            counts = read_counts()
            check(counts == want, f"GPT-2 medium dropout step {i + 1}: "
                                  f"launches {counts} != {want}")
            check(dropout_launches() == _each("d64", layers),
                  f"GPT-2 medium dropout step {i + 1}: dropout launches "
                  f"{dropout_launches()}")
            for k, v in counts.items():
                launches[k] += v
            drops.update(dropout_launches())
            losses.append(float(loss))
            print(f"    step {i + 1}: loss {losses[-1]:.4f}, grad norm "
                  f"{float(gnorm):.4f}, step ms {step_ms[-1]:.2f}, tokens/s "
                  f"{batch * seqlen / (step_ms[-1] / 1e3):.1f}", flush=True)
            del grads
    check(not plain, f"GPT-2 medium dropout: plain versions ran: {plain}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(vocab)) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of ln({vocab})")
    print(f"  GPT-2 medium dropout: {DROPOUT_STEPS} steps, launches exact "
          f"({layers} a step of #5, the pre-pass and #6, each kernel's "
          f"dropout instantiation), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del model, params, state, opt
    torch.cuda.empty_cache()
    model, _ = gpt2m_dropout_model(seed, layers=2)
    ids, labels = toks[0, :, :-1], toks[0, :, 1:]
    loss_k, grads_k = dropout_grads(model, ids, labels, DROP_SEED)
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    reset_counts()
    with plain_versions():
        loss_p, grads_p = dropout_grads(model, ids, labels, DROP_SEED)
    check(all(v == 0 for v in read_counts().values()),
          f"the plain step launched a kernel: {read_counts()}")
    dl = abs(float(loss_k) - float(loss_p))
    rel = {n: max_err(grads_k[n], grads_p[n])
           / max(grads_p[n].abs().max().item(), 1e-30) for n in grads_p}
    worst = max(rel, key=rel.get)
    print(f"  depth 2, batch {batch}, same seeds: loss kernels "
          f"{float(loss_k):.5f} plain {float(loss_p):.5f} (|diff| {dl:.3g}, "
          f"tol {TRAIN_LOSS_TOL}); gradients, max |diff| / max |plain| over "
          f"{len(rel)} parameters: largest {rel[worst]:.4g} ({worst}), median "
          f"{sorted(rel.values())[len(rel) // 2]:.4g} (tol {TRAIN_GRAD_TOL})",
          flush=True)
    check(dl <= TRAIN_LOSS_TOL, f"dropout depth 2: loss differs by {dl}")
    check(rel[worst] <= TRAIN_GRAD_TOL,
          f"dropout depth 2: gradient of {worst} differs by {rel[worst]}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    return launches, drops


def dropout_entries(gen):
    """The phase's main paths of the d 128 and the masked dropout
    instantiations, through the entries a user calls: flash_attn_func at
    A's Llama-3-8B width (GQA, d 128, causal) and flash_attn_varlen_func
    on VL-doc's packed documents (T-long's attention, causal: d 64
    masked), each a forward and a backward with dropout_p DROP_P, the
    counts set to 0 just before and read just after, no plain version.
    Returns the dropout launches by instantiation."""
    from xhy_flash_attention_tpu_torch import (flash_attn_func,
                                               flash_attn_varlen_func)
    b, h, hk, s, d = _dims(T_GQA)
    z = dict(generator=gen, device="cuda")
    qkv = [torch.randn(b, s, n, d, **z).bfloat16().requires_grad_()
           for n in (h, hk, hk)]
    _, h_vl, hk_vl, s_vl, d_vl = _dims(VL_DOC)
    cu = doc_cu_seqlens(gen, s_vl, *VL_DOC_LENGTHS)
    longest = int((cu[1:] - cu[:-1]).max())
    vl = [torch.randn(s_vl, n, d_vl, **z).bfloat16().requires_grad_()
          for n in (h_vl, hk_vl, hk_vl)]
    total = collections.Counter()
    for label, inst, run in (
            ("flash_attn_func at A", "d128", lambda: flash_attn_func(
                *qkv, dropout_p=DROP_P, causal=True,
                dropout_seed=DROP_SEED + 3)),
            ("flash_attn_varlen_func at VL-doc", "d64 masked",
             lambda: flash_attn_varlen_func(
                 *vl, cu, cu, longest, longest, dropout_p=DROP_P,
                 causal=True, dropout_seed=DROP_SEED + 4))):
        with count_plain_calls() as plain:
            reset_dropout_launches()
            out = run()
            out.backward(torch.randn(out.shape, **z).bfloat16())
            torch.cuda.synchronize()
            n = dropout_launches()
        check(not plain, f"dropout {label}: plain versions ran: {plain}")
        check(n == _each(inst), f"dropout {label}: launches {n}")
        check(bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(t.grad).all()) for t in qkv + vl
            if t.grad is not None), f"dropout {label}: non-finite values")
        print(f"  {label}: forward and backward, launches {dict(n)}",
              flush=True)
        total.update(n)
    return total


def dropout_phase(seed, gen):
    """Phase 22: the keep masks bit for bit, the dropout kernels at A,
    T-long, T-packed and FM-doc, then the phase's main paths: GPT-2 medium
    trained with attention dropout (the d 64 instantiations, #5 / #6) and
    dropout_entries (d 128, d 64 masked). Returns the kernel rows, each
    with the launches of its own instantiation on those paths."""
    dropout_mask_probe()
    rows = dropout_kernels(gen, "A", T_GQA)
    torch.cuda.empty_cache()
    rows += dropout_kernels(gen, "T-long", T_LONG)
    torch.cuda.empty_cache()
    rows += dropout_packed(gen)
    torch.cuda.empty_cache()
    rows += dropout_masked(gen)
    torch.cuda.empty_cache()
    reset_counts()
    launches, drops = train_dropout_gpt2m(seed, gen)
    drops.update(dropout_entries(gen))
    for row in rows:
        inst = row.pop("instance")
        row["launches"] = (launches["fused_heads_bwd"] if inst is None
                           else drops[inst])
    print(f"  dropout launches on the phase's main paths, by instantiation: "
          f"{json.dumps(dict(sorted(drops.items())))}", flush=True)
    return rows


# ------------------ phase 3: the fused norm's flags (#7 / #8), and phase 23

NORM_P = 0.1          # gpt2-medium's resid_pdrop
NORM_SEED = 4321
# (label, rows, hidden, RMSNorm, rowscale and layerscale): T-long's norm
# (gpt3m-flash.yaml: b16 s2048, hidden 1024, LayerNorm) with the scales;
# the same shape with dropout alone, as T-drop-resid's blocks run it (b32
# s1024); and Llama-3-8B's width with the scales
NORM_FLAG_SHAPES = (("LayerNorm 32768x1024", 32768, 1024, False, True),
                    ("LayerNorm 32768x1024", 32768, 1024, False, False),
                    ("RMSNorm 4096x4096", 4096, 4096, True, True))


def norm_flag_inputs(gen, rows, hidden, rms, scales):
    """bf16 x0, an fp32 residual, fp32 gamma (beta for LayerNorm) and, with
    ``scales``, a rowscale in [0.5, 1.5) and a layerscale near 1."""
    z = dict(generator=gen, device="cuda")
    x0 = torch.randn(rows, hidden, **z).bfloat16()
    res = 4 * torch.randn(rows, hidden, **z)
    w = 1 + 0.1 * torch.randn(hidden, **z)
    b = None if rms else 0.1 * torch.randn(hidden, **z)
    rs = 0.5 + torch.rand(rows, **z) if scales else None
    cs = 1 + 0.1 * torch.randn(hidden, **z) if scales else None
    flags = dict(rowscale=rs, colscale=cs, dropout_p=NORM_P, seed=NORM_SEED)
    return x0, res, w, b, flags


def norm_mask_probe(rows, hidden, rms, scales):
    """Gate: the keep mask that #7 and #8 apply (with a rowscale and a
    layerscale where ``scales``), read
    back bit for bit against ops common.py's dropout_keep_mask (salt 0, the
    global row and column): #7's residual_out with x0 = 1, residual 0 and
    unit scales is the mask times 1 / (1 - p) exactly; #8's dx0 is 0
    exactly where an element was dropped. Returns the readings."""
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    z = dict(device="cuda")
    ones = torch.ones(rows, hidden, dtype=torch.bfloat16, **z)
    flags = dict(rowscale=torch.ones(rows, **z) if scales else None,
                 colscale=torch.ones(hidden, **z) if scales else None,
                 dropout_p=NORM_P, seed=NORM_SEED)
    w = torch.ones(hidden, **z)
    b = None if rms else torch.zeros(hidden, **z)
    _, resout, mu, rstd = ln.ln_fwd(ones, torch.zeros(rows, hidden, **z), w,
                                    b, 1e-5, rms, torch.float32, True, True,
                                    **flags)
    keep = ln.norm_keep_mask(NORM_SEED, NORM_P, rows, hidden, "cuda")
    want = torch.where(keep, torch.ones(rows, hidden, **z), 0.0) * (
        1.0 / (1.0 - NORM_P))
    check(torch.equal(resout, want),
          f"#7's keep mask at {rows}x{hidden} differs from dropout_keep_mask")
    dout = torch.randn(rows, hidden, **z).bfloat16()
    dx0 = ln.ln_bwd(dout, None, resout, mu, rstd, w, is_rms=rms,
                    has_bias=b is not None, x0_dtype=torch.bfloat16,
                    res_dtype=torch.float32, x0=ones, **flags)[0]
    check(torch.equal(dx0 != 0, keep),
          f"#8's keep mask at {rows}x{hidden} differs from dropout_keep_mask")
    kept = keep.float().mean().item()
    print(f"  norm keep mask {rows}x{hidden}: #7 (residual_out) and #8 "
          f"(dx0's zeros) equal dropout_keep_mask bit for bit, "
          f"{rows * hidden} elements each, kept share {kept:.5f} (1 - p = "
          f"{1 - NORM_P})", flush=True)
    return 2 * rows * hidden


def _contract(what, got, fp32_ref, low, rel):
    """got within twice the bf16 plain version's (``low``) error against
    the fp32 plain version, plus ``rel`` of the largest |fp32_ref|."""
    e, e_low = max_err(got, fp32_ref), max_err(low, fp32_ref)
    tol = 2 * e_low + rel * fp32_ref.float().abs().max().item()
    check(e <= tol, f"{what}: err {e} > 2 x {e_low} + {rel} x max")
    return e, e_low


def check_norm_flags(gen, label, rows, hidden, rms, scales):
    """Phase 3, #7 and #8 with p 0.1 (and, with ``scales``, a rowscale and
    a layerscale; prenorm,
    bf16 x0, fp32 residual, the training path's saved stats): the keep mask
    (norm_mask_probe); every output within twice the bf16 plain version's
    error against the fp32 plain version (1e-5 of the largest entry for
    the fp32 outputs, 1e-4 for the column sums); dgamma, dbeta and
    dcolscale bitwise equal over three runs; times beside the no-flag
    twins, the plain versions and the composed library calls (F.dropout,
    the scales and the add, then F.layer_norm / F.rms_norm: several
    calls), bound by bytes or by the hash's integer floor. Returns the
    forward and backward rows (launches filled from phase 23, by
    instantiation)."""
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    norm_mask_probe(rows, hidden, rms, scales)
    inst = ln.norm_instance(rms, scales, scales)
    eps = 1e-5
    x0, res, w, b, flags = norm_flag_inputs(gen, rows, hidden, rms, scales)
    args = (x0, res, w, b, eps, rms, torch.float32, True, True)
    out, resout, mu, rstd = ln.ln_fwd(*args, **flags)
    low = ln.ln_fwd_ref(*args, **flags)
    f32 = ln.ln_fwd_ref(x0.float(), *args[1:], **flags)
    torch.cuda.synchronize()
    e_out, e_out_low = _contract(f"{label} #7 out", out, f32[0], low[0], 1e-6)
    e_res, _ = _contract(f"{label} #7 residual_out", resout, f32[1], low[1],
                         1e-6)
    del low, f32
    dout = torch.randn(rows, hidden, generator=gen, device="cuda").bfloat16()
    dres_in = torch.randn(rows, hidden, generator=gen, device="cuda")
    kw = dict(is_rms=rms, has_bias=b is not None, x0_dtype=torch.bfloat16,
              res_dtype=torch.float32, x0=x0, **flags)
    bargs = (dout, dres_in, resout, mu, rstd, w)
    runs = [ln.ln_bwd(*bargs, **kw) for _ in range(3)]
    got = runs[0]
    same = all(torch.equal(a, c) for run in runs[1:]
               for a, c in zip(got[2:], run[2:]) if a is not None)
    check(same, f"{label} #8: dgamma / dbeta / dcolscale differ run to run")
    del runs
    low = ln.ln_bwd_ref(*bargs, **kw)
    f32 = ln.ln_bwd_ref(*bargs, **{**kw, "x0_dtype": torch.float32})
    errs = {}
    for i, name in enumerate(("dx0", "dresidual", "dgamma", "dbeta",
                              "dcolscale")):
        if got[i] is not None:
            errs[name] = _contract(f"{label} #8 {name}", got[i], f32[i],
                                   low[i], 1e-5 if i < 2 else 1e-4)[0]
    del low, f32
    torch.cuda.synchronize()

    n = rows * hidden
    # the column vectors read forward (gamma, beta, colscale), and the sums
    # the backward writes as partials (dgamma, dbeta, dcolscale)
    vecs = 1 + (b is not None) + scales
    # rowscale (with the scales), then the stats: rstd, and mu for
    # LayerNorm (RMSNorm neither writes nor reads one)
    row_bytes = rows * (4 * scales + (4 if rms else 8))
    fwd_bytes = n * (2 + 4 + 2 + 4) + row_bytes + hidden * 4 * vecs
    # dout, residual_out, dres_in (and x0, read again for dcolscale) in;
    # dx0 and dresidual out; the row values; gamma (and colscale); the
    # partials (one row of hidden per block of rows, each sum)
    blocks = -(-rows // max(1, min(64, -(-rows // 264))))
    bwd_bytes = (n * (2 + 4 + 4 + 2 * scales + 2 + 4) + row_bytes
                 + hidden * 4 * (1 + scales) + blocks * hidden * 4 * vecs)
    floor = int_floor_ms(n)
    fwd_bound = max((fwd_bytes / PEAK_BYTES * 1e3, "bytes"),
                    (floor, "operations"))
    bwd_bound = max((bwd_bytes / PEAK_BYTES * 1e3, "bytes"),
                    (floor, "operations"))
    rs = flags["rowscale"]
    lx0, lres, lw, lcs, lb = (
        None if t is None else t.detach().requires_grad_()
        for t in (x0, res, w, flags["colscale"], b))
    leaves = [t for t in (lx0, lres, lw, lcs, lb) if t is not None]

    def lib_fwd():
        xs = lx0.float()
        if scales:
            xs = xs * rs[:, None] * lcs
        xs = F.dropout(xs, NORM_P) + lres
        y = (F.rms_norm(xs, (hidden,), lw, eps) if rms else
             F.layer_norm(xs, (hidden,), lw, lb, eps))
        return y.bfloat16(), xs
    with torch.no_grad():
        lib_f = time_ms([lib_fwd])
    both = time_ms([lambda: torch.autograd.grad(lib_fwd(), leaves,
                                                (dout, dres_in))])
    twin = time_ms([lambda: ln.ln_fwd(*args)])
    ms_f = time_ms([lambda: ln.ln_fwd(*args, **flags)])
    twin_b = time_ms([lambda: ln.ln_bwd(*bargs, **{
        **kw, "x0": None, "rowscale": None, "colscale": None,
        "dropout_p": 0.0, "seed": None})])
    ms_b = time_ms([lambda: ln.ln_bwd(*bargs, **kw)])
    plain_f = time_ms([lambda: ln.ln_fwd_ref(*args, **flags)], iters=5)
    plain_b = time_ms([lambda: ln.ln_bwd_ref(*bargs, **kw)], iters=5)
    src = "xhy_flash_attention_tpu_torch/csrc/rms_norm_add.cu"
    what = f"p {NORM_P}, rowscale, layerscale" if scales else f"p {NORM_P}"
    fwd_row = dict(
        name=f"rms_norm_add ({what}; {label})",
        route="cuda", source=src,
        replaces="xhy_flash_attention_tpu/ops/layer_norm.py:48",
        instance=("fwd", inst), max_abs_err=max(e_out, e_res), ms=ms_f,
        plain_ms=plain_f, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library_ms=lib_f)
    report(fwd_row, f"out err {e_out:.3g} (bf16 plain {e_out_low:.3g}), "
                    f"residual_out err {e_res:.3g} against the fp32 plain "
                    f"version; no-flag twin {twin:.4f} ms (x{ms_f / twin:.3f}"
                    f"); bytes {fwd_bytes:.4g}, integer floor {floor:.4f} "
                    "ms; library: " + ("the scales, " if scales else "")
                    + "F.dropout, the add and F."
                    + ("rms_norm" if rms else "layer_norm")
                    + " (several calls)")
    bwd_row = dict(
        name=f"ln_bwd ({what}; {label})",
        route="cuda", source=src,
        replaces="xhy_flash_attention_tpu/ops/layer_norm.py:102",
        instance=("bwd", inst), max_abs_err=max(errs.values()), ms=ms_b,
        plain_ms=plain_b, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library_ms=both - lib_f)
    report(bwd_row, "errors against the fp32 plain version "
                    + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                    + "; dgamma / dbeta" + (" / dcolscale" if scales else "")
                    + " bitwise equal over 3 runs"
                    f"; no-flag twin {twin_b:.4f} ms (x{ms_b / twin_b:.3f}); "
                    f"bytes {bwd_bytes:.4g}"
                    + (" (x0 read again for dcolscale)" if scales else "")
                    + ", "
                    f"integer floor {floor:.4f} ms; library: autograd of the "
                    "composed forward, backward alone")
    return [fwd_row, bwd_row]


def norm_flag_kernels(gen):
    rows = []
    for label, n, h, rms, scales in NORM_FLAG_SHAPES:
        rows += check_norm_flags(gen, label, n, h, rms, scales)
        torch.cuda.empty_cache()
    return rows


def norm_dropout_launches():
    """The fused norm's dropout launches since the last reset, forward and
    backward, each a Counter by instantiation (ln.norm_instance)."""
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    return (collections.Counter(ln.ln_fwd.dropout_launches),
            collections.Counter(ln.ln_bwd.dropout_launches))


def reset_norm_dropout_launches():
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    ln.ln_fwd.dropout_launches.clear()
    ln.ln_bwd.dropout_launches.clear()


def resid_dropout_model(seed, layers=None):
    """GPT-2 medium (GPT2_MEDIUM) in bf16 from random weights with its
    published dropout rates (embd_pdrop, resid_pdrop, attn_pdrop 0.1): the
    port's GPTLMHeadModel builds its Blocks as the JAX GPTModel does (block
    0's resid_dropout1 is embd_pdrop); and its fp32 master parameters."""
    import dataclasses
    from xhy_flash_attention_tpu_torch import GPTLMHeadModel
    from xhy_flash_attention_tpu_torch.models.gpt import \
        gpt2_config_to_gpt_config
    cfg = gpt2_config_to_gpt_config(types.SimpleNamespace(**GPT2_MEDIUM),
                                    torch.bfloat16)
    cfg = dataclasses.replace(
        cfg, num_hidden_layers=layers or GPT2_MEDIUM["n_layer"])
    check((cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop) == (DROP_P,) * 3,
          "T-drop-resid takes gpt2-medium's published dropout rates")
    model = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    blocks = model.transformer.layers
    check(blocks[0].resid_dropout1 == cfg.embd_pdrop and all(
        (blk.resid_dropout1, blk.resid_dropout2) == (cfg.resid_pdrop,) * 2
        for blk in blocks[1:]), "the blocks' residual dropout rates")
    params = {n: p.detach() if p.dtype == torch.float32 else
              p.detach().float().clone() for n, p in model.named_parameters()}
    return model, params


def resid_dropout_grads(model, ids, labels, seed):
    """Loss and fp32 gradients of one training forward through the port's
    Blocks with residual and attention dropout: each block's three seeds
    (norm1, norm2, attention) drawn in turn from a CPU generator seeded
    ``seed``, as the JAX Block takes them (seeds=(s1, s2) and the mixer's
    own); the embedding, the final norm (no dropout: the reference's final
    norm takes no seed) and the tied LM head around them."""
    from xhy_flash_attention_tpu_torch.losses.cross_entropy import \
        cross_entropy_loss
    from xhy_flash_attention_tpu_torch.modules.mha import draw_dropout_seed
    for p in model.parameters():
        p.grad = None
    gen = torch.Generator().manual_seed(seed)
    t = model.transformer
    hidden, residual = t.embeddings(ids), None
    for layer in t.layers:
        s1, s2, sa = (draw_dropout_seed(gen) for _ in range(3))
        hidden, residual, _ = layer(hidden, residual, deterministic=False,
                                    dropout_seed=sa, seeds=(s1, s2))
    hidden = t.norm_f(hidden, residual, False, model.config.residual_in_fp32)
    logits = F.linear(hidden, t.embeddings.word_embeddings.weight)
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1)).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.float()
                           for n, p in model.named_parameters()}


def train_resid_dropout_gpt2m(seed, gen):
    """Phase 23, T-drop-resid: GPT-2 medium with embedding, residual and
    attention dropout at 0.1 through the port's Blocks (resid_dropout_grads)
    for DROPOUT_STEPS steps of the recipe's AdamW at gpt2m-flash.yaml's
    batch and seqlen. Gates: exact launches, with the fused norm's dropout
    instantiations 2 a block forward and 2 backward and the attention's
    dropout instantiations; no plain version; finite losses; step 1 twice
    with the same seeds bitwise equal, another seed different; at depth 2
    the kernels against the plain versions under the same seeds (phase 9's
    limits). Returns the norm's dropout launches (forward, backward), by
    instantiation."""
    from xhy_flash_attention_tpu_torch.training import load_config
    from xhy_flash_attention_tpu_torch.training.optim import Optimizer
    rc = load_config(RECIPES["T-packed"][0])
    batch, seqlen = rc.data.batch_size, rc.data.seqlen
    layers = GPT2_MEDIUM["n_layer"]
    vocab = GPT2_MEDIUM["vocab_size"]
    model, params = resid_dropout_model(seed)
    opt = Optimizer(rc.optimizer, rc.scheduler)
    state = opt.init(params)
    toks = torch.randint(0, vocab, (DROPOUT_STEPS, batch, seqlen + 1),
                         generator=gen, device="cuda")

    def sync():
        with torch.no_grad():
            for n, p in model.named_parameters():
                if params[n].data_ptr() != p.data_ptr():
                    p.copy_(params[n])
    print(f"  GPT-2 medium widths ({layers} layers, hidden "
          f"{GPT2_MEDIUM['n_embd']}), bf16, random weights; embd_pdrop, "
          f"resid_pdrop and attn_pdrop {DROP_P} (published); batch {batch} "
          f"x seqlen {seqlen}, {DROPOUT_STEPS} steps, the recipe's AdamW",
          flush=True)
    ids, labels = toks[0, :, :-1], toks[0, :, 1:]
    loss_a, grads_a = resid_dropout_grads(model, ids, labels, DROP_SEED)
    loss_b, grads_b = resid_dropout_grads(model, ids, labels, DROP_SEED)
    check(float(loss_a) == float(loss_b) and all(
        torch.equal(grads_a[n], grads_b[n]) for n in grads_a),
        "T-drop-resid: a repeat with the same seeds differs")
    del grads_b
    loss_c, grads_c = resid_dropout_grads(model, ids, labels, DROP_SEED + 1)
    name = "transformer.layers.0.norm1.weight"
    check(float(loss_c) != float(loss_a)
          and not torch.equal(grads_c[name], grads_a[name]),
          "T-drop-resid: another seed gives the same step")
    print(f"  step 1 twice with the same seeds: loss {float(loss_a):.6f} "
          f"both times, every gradient bitwise equal; another seed: loss "
          f"{float(loss_c):.6f}", flush=True)
    del grads_a, grads_c
    want = {k: 0 for k in counters()}
    want.update({"rms_norm_add": 2 * layers + 1, "ln_bwd": 2 * layers + 1,
                 "flash_fwd (fused_heads)": layers, "flash_bwd_prep": layers,
                 "fused_heads_bwd": layers})
    drop_ln = {"layer_norm": 2 * layers}  # dropout alone, no scales
    norm_drops = [collections.Counter(), collections.Counter()]
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with count_plain_calls() as plain:
        for i in range(DROPOUT_STEPS):
            ids, labels = toks[i, :, :-1], toks[i, :, 1:]
            reset_counts()
            reset_dropout_launches()
            reset_norm_dropout_launches()
            t0 = time.perf_counter()
            loss, grads = resid_dropout_grads(model, ids, labels,
                                              DROP_SEED + 10 + i)
            gnorm = opt.update(grads, state, params)
            sync()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            check(counts == want, f"T-drop-resid step {i + 1}: launches "
                                  f"{counts} != {want}")
            check(dropout_launches() == _each("d64", layers),
                  f"T-drop-resid step {i + 1}: attention dropout launches "
                  f"{dropout_launches()}")
            nd = norm_dropout_launches()
            check(nd == (drop_ln, drop_ln),
                  f"T-drop-resid step {i + 1}: the norm's dropout launches "
                  f"{nd}, not 2 a block forward and backward")
            for total, c in zip(norm_drops, nd):
                total.update(c)
            losses.append(float(loss))
            print(f"    step {i + 1}: loss {losses[-1]:.4f}, grad norm "
                  f"{float(gnorm):.4f}, step ms {step_ms[-1]:.2f}, tokens/s "
                  f"{batch * seqlen / (step_ms[-1] / 1e3):.1f}", flush=True)
            del grads
    STEP_MS["T-drop-resid"] = step_ms
    check(not plain, f"T-drop-resid: plain versions ran: {plain}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(vocab)) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of ln({vocab})")
    t_drop = STEP_MS.get("T-drop", [])
    print(f"  T-drop-resid: {DROPOUT_STEPS} steps, launches exact (the "
          f"norm's dropout instantiations {2 * layers} forward and "
          f"{2 * layers} backward a step), step ms "
          f"{', '.join(f'{x:.2f}' for x in step_ms)} beside phase 22's "
          f"T-drop (attention dropout alone) "
          f"{', '.join(f'{x:.2f}' for x in t_drop)} in this run; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    del model, params, state, opt
    torch.cuda.empty_cache()
    model, _ = resid_dropout_model(seed, layers=2)
    ids, labels = toks[0, :, :-1], toks[0, :, 1:]
    loss_k, grads_k = resid_dropout_grads(model, ids, labels, DROP_SEED)
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    reset_counts()
    with plain_versions():
        loss_p, grads_p = resid_dropout_grads(model, ids, labels, DROP_SEED)
    check(all(v == 0 for v in read_counts().values()),
          f"the plain step launched a kernel: {read_counts()}")
    dl = abs(float(loss_k) - float(loss_p))
    rel = {n: max_err(grads_k[n], grads_p[n])
           / max(grads_p[n].abs().max().item(), 1e-30) for n in grads_p}
    worst = max(rel, key=rel.get)
    print(f"  depth 2, batch {batch}, same seeds: loss kernels "
          f"{float(loss_k):.5f} plain {float(loss_p):.5f} (|diff| {dl:.3g}, "
          f"tol {TRAIN_LOSS_TOL}); gradients, max |diff| / max |plain| over "
          f"{len(rel)} parameters: largest {rel[worst]:.4g} ({worst}), median "
          f"{sorted(rel.values())[len(rel) // 2]:.4g} (tol {TRAIN_GRAD_TOL})",
          flush=True)
    check(dl <= TRAIN_LOSS_TOL, f"T-drop-resid depth 2: loss differs by {dl}")
    check(rel[worst] <= TRAIN_GRAD_TOL,
          f"T-drop-resid depth 2: gradient of {worst} differs by "
          f"{rel[worst]}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    return norm_drops


def norm_flag_entries(gen):
    """The rowscale and layerscale instantiations' main paths, through the
    entries a user calls: dropout_add_layer_norm at T-long's norm and
    dropout_add_rms_norm at Llama-3-8B's width, each with p 0.1, a rowscale
    and a layerscale, prenorm with an fp32 residual, forward and backward
    through the autograd function; counts set to 0 just before and read
    just after, no plain version. Returns the norm's dropout launches, by
    instantiation."""
    from xhy_flash_attention_tpu_torch import (dropout_add_layer_norm,
                                               dropout_add_rms_norm)
    from xhy_flash_attention_tpu_torch.ops import layer_norm as ln
    total = [collections.Counter(), collections.Counter()]
    for label, rows, hidden, rms, scales in NORM_FLAG_SHAPES:
        if not scales:  # T-drop-resid's blocks run it
            continue
        x0, res, w, b, flags = norm_flag_inputs(gen, rows, hidden, rms,
                                                scales)
        leaves = [t.requires_grad_() for t in (x0, res, w, flags["colscale"])
                  ] + ([b.requires_grad_()] if b is not None else [])
        fn = dropout_add_rms_norm if rms else dropout_add_layer_norm
        with count_plain_calls() as plain:
            reset_counts()
            reset_norm_dropout_launches()
            out, resout = fn(x0.view(-1, 1024, hidden),
                             res.view(-1, 1024, hidden), w, b, NORM_P, 1e-5,
                             rowscale=flags["rowscale"].view(-1, 1024),
                             layerscale=flags["colscale"], prenorm=True,
                             residual_in_fp32=True, seed=NORM_SEED + 1)
            grads = torch.autograd.grad((out, resout), leaves,
                                        (torch.ones_like(out),
                                         torch.ones_like(resout)))
            torch.cuda.synchronize()
            nd = norm_dropout_launches()
            counts = read_counts()
        check(not plain, f"norm entry {label}: plain versions ran: {plain}")
        one = collections.Counter({ln.norm_instance(rms, True, True): 1})
        check(nd == (one, one) and counts["rms_norm_add"] == 1
              and counts["ln_bwd"] == 1,
              f"norm entry {label}: launches {nd} {counts}")
        check(all(bool(torch.isfinite(g).all()) for g in grads)
              and bool(torch.isfinite(out).all()),
              f"norm entry {label}: non-finite values")
        print(f"  {fn.__name__} at {label}: forward and backward with p "
              f"{NORM_P}, rowscale and layerscale, launches "
              f"{dict(nd[0])} forward, {dict(nd[1])} backward", flush=True)
        for t, c in zip(total, nd):
            t.update(c)
        del x0, res, out, resout, grads, leaves
        torch.cuda.empty_cache()
    return total


def resid_dropout_phase(seed, gen, rows):
    """Phase 23: T-drop-resid, then the norm's flagged entries; fills the
    launches of phase 3's flagged #7 / #8 rows with their own
    instantiation's dropout launches on those paths."""
    fwd, bwd = train_resid_dropout_gpt2m(seed, gen)
    ef, eb = norm_flag_entries(gen)
    fwd.update(ef)
    bwd.update(eb)
    for row in rows:
        inst = row.pop("instance", None)
        if inst is not None:
            row["launches"] = (fwd if inst[0] == "fwd" else bwd)[inst[1]]
    print(f"  the norm's dropout launches on the phase's main paths, by "
          f"instantiation: forward {json.dumps(dict(sorted(fwd.items())))}, "
          f"backward {json.dumps(dict(sorted(bwd.items())))}", flush=True)


# ---------------------------------------------------------------- phase 24

def neox_config():
    """Pythia-6.9B's config as a transformers.GPTNeoXConfig where
    transformers is installed, else an object with its field names."""
    try:
        import transformers
    except ImportError:
        return types.SimpleNamespace(**PYTHIA_6_9B), "SimpleNamespace"
    return transformers.GPTNeoXConfig(**PYTHIA_6_9B), "GPTNeoXConfig"


def neox_serving(seed, gen):
    """Phase 24, NeoX-6.9B: GPT-NeoX at EleutherAI/pythia-6.9b's widths
    (PYTHIA_6_9B through gpt_neox_config_to_gpt_config: parallel block with
    untied norms, partial rotary 32 of 128, untied embeddings) with random
    bf16 weights at full depth serves request N (serve: eager and graph,
    exact launches, graph tokens equal to eager tokens, no plain version),
    and its kernel path is held to the plain path (kernel_vs_plain) on the
    prefill and one decode step. Returns the graph run's launches."""
    from xhy_flash_attention_tpu_torch import (GPTLMHeadModel,
                                               gpt_neox_config_to_gpt_config)
    hf, kind = neox_config()
    print(f"  {kind}'s rotary fields: " + ", ".join(
        f"{k} {getattr(hf, k, None)}" for k in (
            "rotary_pct", "rotary_emb_base", "partial_rotary_factor",
            "rope_theta", "rope_parameters")), flush=True)
    cfg = gpt_neox_config_to_gpt_config(hf, torch.bfloat16)
    check(cfg.parallel_block and not cfg.parallel_block_tied_norm
          and int(cfg.dim_head * cfg.rotary_emb_fraction) == 32
          and cfg.rotary_emb_base == PYTHIA_6_9B["rotary_emb_base"]
          and not cfg.tie_word_embeddings,
          f"Pythia-6.9B maps to {cfg}")
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  config from a {kind} (rotary fraction "
          f"{cfg.rotary_emb_fraction}, base {cfg.rotary_emb_base}); "
          f"{n_params / 1e9:.3f} B parameters built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with count_plain_calls() as plain:
        counts, _, _ = serve(model, gen, "N")
    check(not plain, f"request N: plain versions ran: {plain}")
    for what in ("eager", "graph"):
        r = SERVED[("N", what)]
        print(f"  NeoX-6.9B request N, {what}: prefill "
              f"{r['prefill_tok_s']:.1f} tok/s, decode "
              f"{r['ms_per_step']:.3f} ms/step ({r['tok_s']:.1f} tok/s), "
              f"peak {r['peak_gib']:.2f} GiB", flush=True)
    torch.cuda.empty_cache()
    kernel_vs_plain(model, gen, "N")
    del model
    torch.cuda.empty_cache()
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, global_sliding_window_mask, llama_config_to_gpt_config)
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
    # printed; the JSON line keeps request A's rows, the shapes of the path
    check_decode(gen, "B")
    rows += [check_decode(gen, "A", dt) for dt in QUANT]
    for dt in (torch.bfloat16,) + QUANT:
        check_decode(gen, "b8 S8192", dt)
    torch.cuda.empty_cache()
    rows += [check_splitkv(gen, dt, rows[3]["ms"])
             for dt in (torch.bfloat16, torch.int8)]
    rows += [check_paged(gen, "chunked", torch.bfloat16, clusters=True),
             check_paged(gen, "chunked", torch.int8),
             check_paged(gen, "chunked", torch.bfloat16, sq=512),
             check_paged(gen, "chunked", torch.int8, sq=512),
             check_paged(gen, "page", torch.bfloat16)]
    torch.cuda.empty_cache()
    rows.append(check_flash_fwd(gen, "T-long"))
    torch.cuda.empty_cache()
    rows += check_flash_bwd(gen, T_LONG, "T-long")
    torch.cuda.empty_cache()
    rows += check_flash_bwd(gen, T_GQA, "GQA d128")
    rows.append(check_fused_heads_bwd(gen))
    torch.cuda.empty_cache()
    rows += [check_ln_bwd(gen, 32768, 1024, False, "LayerNorm 32768x1024"),
             check_ln_bwd(gen, 4096, 4096, True, "RMSNorm 4096x4096")]
    torch.cuda.empty_cache()
    norm_rows = norm_flag_kernels(gen)
    rows += norm_rows
    b, _, _, s, _ = _dims(FM_DOC)
    rows += check_sparse_kernels(
        gen, "FlashMask", FM_DOC, True,
        lambda g: _flags(doc_indices(g, b, s), causal=True))
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(BS)
    rows += check_sparse_kernels(
        gen, "block-sparse", BS, False,
        lambda g: _flags(block_mask=bigbird_mask(g, b, s // BS_BLOCK)))
    torch.cuda.empty_cache()
    b, _, _, s, _ = _dims(FM_SWG)
    rows += check_sparse_kernels(
        gen, "FM-swg", FM_SWG, True,
        lambda g: _flags(global_sliding_window_mask(
            b, s, SWG_WINDOW, SWG_GLOBAL), causal=True))
    torch.cuda.empty_cache()
    rows += check_sparse_kernels(gen, "SW", SW, True, lambda g: {},
                                 window=SW_WINDOW)
    check_sw_vs_flashmask(gen)
    torch.cuda.empty_cache()
    s = VL_DOC["s"]
    rows += check_sparse_kernels(
        gen, "VL-doc", VL_DOC, True,
        lambda g: vl_flags(*(doc_cu_seqlens(g, s, *VL_DOC_LENGTHS),) * 2, s, s))
    torch.cuda.empty_cache()
    rows.append(check_reduced(gen))
    torch.cuda.empty_cache()
    rows += fp32_kernels(gen)
    torch.cuda.empty_cache()
    rows += fp32_masked_kernels(gen)
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
    launches = {}  # kernel row -> its launches on the main path

    def add(counts):
        for k, v in counts.items():
            totals[k] += v
        return counts

    for name in REQUESTS:
        counts, seq, scores = serve(model, gen, name)
        launches["flash_decode"] = launches.get("flash_decode", 0) + add(
            counts)["flash_decode"]
        if name == "A":
            seq_a, scores_a = seq, scores
    print("[4b] paged continuous batching: InferenceEngine, 12 requests",
          flush=True)
    for dt in (torch.bfloat16, torch.int8):
        counts, st = serve_engine(model, dt, args.seed)
        add(counts)
        if dt == torch.bfloat16:
            launches["paged_decode (chunked, bf16)"] = LAYERS * st["decode"]
            launches["paged_decode (chunked, bf16, sq 512)"] = \
                LAYERS * st["chunk"]
        else:
            launches["paged_decode (chunked, int8)"] = LAYERS * st["decode"]
            launches["paged_decode (chunked, int8, sq 512)"] = \
                LAYERS * st["chunk"]
        torch.cuda.empty_cache()
    print("[4c] flash_attn_with_kvcache and quantized dense caches",
          flush=True)
    per_case = kvcache_api(gen)
    for kind, counts in per_case.items():
        add(counts)
    launches["flash_decode_splitkv (bf16)"] = \
        per_case["bf16"]["flash_decode_splitkv"]
    launches["flash_decode_splitkv (int8)"] = \
        per_case["int8"]["flash_decode_splitkv"]
    launches["paged_decode (page, bf16)"] = \
        per_case["paged"]["paged_decode (page)"]
    launches["flash_decode (e4m3)"] = per_case["e4m3"]["flash_decode"]
    for dt in QUANT:
        reset_counts()
        quantized_decode(model, "A", seq_a, scores_a, dt)
        counts = add(decode_launches(f"decode(cache_dtype={SHORT[dt]})",
                                     *REQUESTS["A"][1:]))
        key = f"flash_decode ({SHORT[dt]})"
        launches[key] = launches.get(key, 0) + counts["flash_decode"]
    del seq_a, scores_a
    check(all(totals[k] > 0 for k in SERVING_KERNELS),
          f"a kernel of the serving path never launched: {totals}")
    print(f"  launches on the main path, by kernel: {json.dumps(totals)}",
          flush=True)
    print("[5] the kernel path against the plain path, full width and depth",
          flush=True)
    for name in REQUESTS:
        kernel_vs_plain(model, gen, name)
    torch.cuda.empty_cache()
    engines = {dt: engine_vs_plain(model, dt, args.seed)
               for dt in (torch.bfloat16, torch.int8)}
    del engines[torch.int8]
    torch.cuda.empty_cache()
    print("[6] where the time goes", flush=True)
    for name in REQUESTS:
        prof = decode_breakdown(model, gen, name)
        if name == "A":
            bf16_matmul_ms = prof[True]["device_ms_per_step"].get("matmul",
                                                                  0.0)
    engine_breakdown(engines.pop(torch.bfloat16))
    torch.cuda.empty_cache()
    chunk_breakdown(model, args.seed)
    del model
    torch.cuda.empty_cache()
    print("[7] tiny model: the card (bf16) against the CPU (fp32)",
          flush=True)
    tiny_parity()

    print("[8] training through train(config, **overrides): T-long, then "
          "T-packed", flush=True)
    trainers = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in RECIPES:
            trainers[name], summary = train_recipe(name, args.seed, tmp)
            add(summary["launches"])
            torch.cuda.empty_cache()
        check(all(totals[k] > 0 for k in TRAINING_KERNELS),
              f"a kernel of the training path never launched: {totals}")
        print("[9] one training step at depth 2, kernels against plain "
              "versions", flush=True)
        for name in RECIPES:
            train_vs_plain(name, args.seed, tmp)
            torch.cuda.empty_cache()
    print("[10] where a training step's time goes", flush=True)
    for name, trainer in trainers.items():
        train_breakdown(trainer, name)
    del trainers, trainer  # the loop's last one would stay on the card
    print(f"  launches on the main path, by kernel: {json.dumps(totals)}",
          flush=True)
    torch.cuda.empty_cache()
    print("[11] sparse masks: FM-doc, FM-swg and its reduced scores, FM-full, "
          "BS; then FM-doc, FM-swg (and its reduced scores) and BS in fp32",
          flush=True)
    launches.update(sparse_masks(gen))
    torch.cuda.empty_cache()
    print("[12] Mistral-7B width, 32 layers, random bf16 weights: request W "
          "(batch 2, prompt 8192, 32 decode steps)", flush=True)
    w_counts = mistral_serving(args.seed, gen)
    launches["flash_fwd (SW)"] = w_counts["flash_fwd (flash_attention_fwd)"]
    print("[13] varlen and windowed entries, forward and backward: VL-doc, "
          "VL-gqa, SW, VL-doc in fp32", flush=True)
    for key, n in varlen_entries(gen).items():
        launches[key] = launches.get(key, 0) + n
    torch.cuda.empty_cache()
    print("[14] attention bias, forward and backward with dbias: Llama-3-8B "
          "width (shared, attn_mask, per-head) and T-long (per-head, "
          "batch-broadcast), then the C-API bridge", flush=True)
    for row in bias_entries(gen):
        launches[row["name"]] = row["launches"]
        rows.append(row)
    print("[15] fp8 prefill through flash_attn_fp8_func: FP8-A, FP8-8k, "
          "FP8-d64, then a window, softcap and odd lengths", flush=True)
    for row in fp8_prefill(gen):
        launches[row["name"]] = row["launches"]
        rows.append(row)
    torch.cuda.empty_cache()
    print("[16] T-8k: experiment/pile/gpt3m-flash-8k.yaml under its remat "
          "(save_attn), then remat_policy save_dots and nothing, and no "
          "remat", flush=True)
    train_with_remat(args.seed)
    torch.cuda.empty_cache()
    print("[17] weight-only int8 / int4 serving at Llama-3-8B width: "
          "request A, the engine with int8 weights", flush=True)
    weight_quant_serving(args.seed, gen, bf16_matmul_ms)
    torch.cuda.empty_cache()
    print("[18] cell G: GPT-2 XL in fp32 (hidden 1600, 48 layers, 25 heads, "
          "random weights under Hugging Face's names): request G (batch 4, "
          "prompt 896, 128 steps), the engine on fp32 pages", flush=True)
    launches.update(gpt2_xl_serving(args.seed, gen))
    print("[19] cell T-packed-fp32: experiment/owt/gpt2m-flash.yaml with "
          "dtype float32 at full width and depth, then depth 2 against the "
          "fp32 and float64 plain paths", flush=True)
    launches.update(train_packed_fp32(args.seed))
    torch.cuda.empty_cache()
    print("[20] cell T-doc-fp32: experiment/owt/gpt2m-flash.yaml in float32 "
          "on packed documents (segment ids), full width and depth, then "
          "depth 2 against the fp32 and float64 plain paths", flush=True)
    t_doc = train_doc_fp32(args.seed)
    print(f"  T-doc-fp32 launches on its main path: "
          f"{json.dumps({k: v for k, v in t_doc.items() if v})}", flush=True)
    torch.cuda.empty_cache()
    print("[21] fp32 with an attention bias, forward and backward with "
          "dbias: G-pad, G-alibi (GPT-2 XL's attention), L-shared, L-bh "
          "(Llama-3-8B's), G-bf16bias, then the C-API bridge", flush=True)
    bias_rows, _ = fp32_bias_entries(gen)
    for row in bias_rows:
        launches[row["name"]] = row["launches"]
    rows += bias_rows
    torch.cuda.empty_cache()
    print("[22] attention dropout: the keep masks of #1, #2 and #3 bit for "
          "bit, the dropout kernels at A, T-long, T-packed and FM-doc, then "
          "GPT-2 medium trained with attn_pdrop 0.1", flush=True)
    for row in dropout_phase(args.seed, gen):
        launches[row["name"]] = row["launches"]
        rows.append(row)
    torch.cuda.empty_cache()
    print("[23] T-drop-resid: GPT-2 medium through the port's Blocks with "
          "embd_pdrop, resid_pdrop and attn_pdrop 0.1, then the norm's "
          "entries with p 0.1, a rowscale and a layerscale", flush=True)
    resid_dropout_phase(args.seed, gen, norm_rows)
    for row in norm_rows:
        launches[row["name"]] = row["launches"]
    torch.cuda.empty_cache()
    print("[24] NeoX-6.9B: GPT-NeoX at pythia-6.9b's widths (hidden 4096, "
          "32 layers, 32 heads of 128, partial rotary 0.25, parallel block "
          "with untied norms), random bf16 weights: request N (batch 2, "
          "prompt 1024, 64 decode steps)", flush=True)
    neox_serving(args.seed, gen)

    for row in rows:
        row["launches"] = launches.get(
            row["name"], totals.get(row.get("kernel", row["name"])))
        check(row["launches"] > 0, f"{row['name']} never launched on the "
                                   "main path")
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
