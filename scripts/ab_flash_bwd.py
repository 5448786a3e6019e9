#!/usr/bin/env python3
"""A/B timing of the dense attention backward's design choices on one card.

    python3 scripts/ab_flash_bwd.py                      # every variant
    python3 scripts/ab_flash_bwd.py base pingpong       # some of them
    python3 scripts/ab_flash_bwd.py --masked base masked_noband

Each variant is the kernel sources of ``xhy_flash_attention_tpu_torch/csrc``
with a few text edits (``VARIANTS``), copied into
``xhy_flash_attention_tpu_torch/build/ab/<name>`` (ignored by git), built
there and timed in a child process of its own: the pre-pass, the dK/dV and
dQ kernels and the whole backward (``flash_attention_bwd``) at T-long's
attention (b16 h16 s2048 d64 causal) and at Llama-3-8B width's (b2 h32 hk8
s2048 d128 causal), and the packed entry (#6) at T-packed's (b32 s1024 h16
d64 causal), with CUDA events after a warm-up. Each variant's gradients
are held against the plain backward at T-long (largest error over the
largest entry, printed). With ``--masked`` each variant also times the
masked kernels (dK/dV and dQ) at chip_smoke.py's FM-doc, BS and FM-swg
masks. The variants run in turns, first to last and then last to first,
so that each is timed twice on the same card. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "xhy_flash_attention_tpu_torch" / "csrc"
AB_ROOT = ROOT / "xhy_flash_attention_tpu_torch" / "build" / "ab"

# name -> [(file, old text, new text)]: each old text must occur in the file
VARIANTS = {
    "base": [],
    # softcap tested at run time inside the unrolled elementwise loops
    "softcap_runtime": [
        ("flash_bwd.cu", "  if (SOFTCAP) {", "  if (softcap > 0.f) {")],
    # dQ on 64-key tiles at d 64 too
    "dq_keys64": [
        ("flash_bwd.cu", "return d == 64 ? 128 : 64;", "return 64;")],
    # both of the above: the first design's elementwise work and tiles
    "softcap_runtime+dq_keys64": [
        ("flash_bwd.cu", "  if (SOFTCAP) {", "  if (softcap > 0.f) {"),
        ("flash_bwd.cu", "return d == 64 ? 128 : 64;", "return 64;")],
    # the two consumers take turns to issue their wgmma batches (named
    # barriers 1 and 2: a consumer issues after the other issued its last)
    "pingpong": [
        ("hopper.cuh", '''  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}''', '''  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}'''),
        ("flash_bwd.cu", "template <int D>\nstruct DkvSmem {",
         "__device__ __forceinline__ void turn_wait(int cw) { "
         "sm90::named_barrier(1 + cw, 256); }\n"
         "__device__ __forceinline__ void turn_pass(int cw) { "
         "sm90::named_barrier_arrive(2 - cw, 256); }\n\n"
         "template <int D>\nstruct DkvSmem {"),
        ("flash_bwd.cu", "    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;\n",
         "    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;\n"
         "    if (cw == 1) turn_pass(1);\n"),
        ("flash_bwd.cu", "        sm90::wgmma_fence();\n        issue_",
         "        turn_wait(cw);\n        sm90::wgmma_fence();\n        issue_"),
        ("flash_bwd.cu", "        sm90::wgmma_fence();\n        // S^T",
         "        turn_wait(cw);\n        sm90::wgmma_fence();\n        // S^T"),
        ("flash_bwd.cu", "        sm90::wgmma_commit();\n        sm90::wgmma_wait<0>();",
         "        sm90::wgmma_commit();\n        turn_pass(cw);\n"
         "        sm90::wgmma_wait<0>();"),
        ("flash_bwd.cu", "    }\n  }\n}\n\n// ---- dQ\n",
         "    }\n    if (cw == 0) turn_wait(0);\n  }\n}\n\n// ---- dQ\n"),
        ("flash_bwd.cu", "                    t);\n    }\n  }\n}",
         "                    t);\n    }\n    if (cw == 0) turn_wait(0);\n  }\n}"),
    ],
    # Timing probes of the masked route (their results are wrong): no
    # FlashMask band test (dQ: the bands still loaded), ...
    "masked_noband": [
        ("flash_bwd.cu", "if (fh != bh) {  // this thread's keys' bands, read under the "
         "products", "if (false) {"),
        ("flash_bwd.cu", "} else if (!MASKED || !(flags & kBand)) {",
         "} else if (true) {")],
    # ... and every tile on the unmasked code (no elementwise test at all)
    "masked_noelem": [
        ("flash_bwd.cu", "if (fh != bh) {  // this thread's keys' bands, read under the "
         "products", "if (false) {"),
        ("flash_bwd.cu", "const int band = flags & kBand;", "const int band = 0;"),
        ("flash_bwd.cu", "        if (!(flags & kElem)) {", "        if (true) {")],
    # dK/dV's elementwise branch first, as the unmasked kernel had it
    # before the masked instantiation joined it
    "dkv_elem_first": [
        ("flash_bwd.cu", """        if (!(flags & kElem)) {
          dkv_p_ds<false, SOFTCAP>(s, dp, lse, delta, key0, m0, p, t);
        } else if (!MASKED || !(flags & kBand)) {
          dkv_p_ds<true, SOFTCAP>(s, dp, lse, delta, key0, m0, p, t);""",
         """        if ((flags & kElem) && (!MASKED || !(flags & kBand))) {
          dkv_p_ds<true, SOFTCAP>(s, dp, lse, delta, key0, m0, p, t);
        } else if (!(flags & kElem)) {
          dkv_p_ds<false, SOFTCAP>(s, dp, lse, delta, key0, m0, p, t);""")],
    # the unmasked dK/dV tile loop with its bound in the loop condition, as
    # before the masked instantiation joined the kernel
    "dkv_loop_cond": [
        ("flash_bwd.cu", "      for (int idx = 0;; ++idx, ++it) {",
         "      for (int idx = 0; MASKED || idx < group * n_tiles; ++idx, ++it) {"),
        ("flash_bwd.cu", "          if (idx == group * n_tiles) break;\n", "")],
    # the producer emits each head's tiles in one pass, in candidate order
    # (the elementwise ones not first)
    "masked_onepass": [
        ("flash_bwd.cu", "for (int pass = 0; pass < 2; ++pass) {",
         "for (int pass = 0; pass < 1; ++pass) {"),
        ("flash_bwd.cu", "f >= 0 && ((f & kElem) != 0) == (pass == 0)", "f >= 0")],
}


def make_variant(name: str) -> Path:
    dst = AB_ROOT / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, old, new in VARIANTS[name]:
        path = dst / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {fname} has no {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def masked_child(label: str) -> list:
    """Time the masked kernels at chip_smoke.py's FM-doc, BS and FM-swg."""
    import torch
    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, common, fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for name, shape, causal in (("FM-doc", cs.FM_DOC, True),
                                ("BS", cs.BS, False),
                                ("FM-swg", cs.FM_SWG, True)):
        b, h, hk, s, d = cs._dims(shape)
        q, k, v, do = cs._sparse_inputs(gen, shape)
        if name == "FM-doc":
            flags = cs._flags(cs.doc_indices(gen, b, s), causal=True)
        elif name == "BS":
            flags = cs._flags(block_mask=cs.bigbird_mask(gen, b,
                                                         s // cs.BS_BLOCK))
        else:
            flags = cs._flags(global_sliding_window_mask(
                b, s, cs.SWG_WINDOW, cs.SWG_GLOBAL), causal=True)
        kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0)
        out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw,
                                           **flags)
        qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        args = (qs, k, v, do, lse, delta, *grads)
        masks = common.KernelMasks(b, h, s, s, **flags)
        times = [time_ms(lambda fn=fn: fn(*args, masks=masks, **kw),
                         iters=10)
                 for fn in (bwd.flash_bwd_dkv, bwd.flash_bwd_dq)]
        lines.append(f"  [{label}] {name}: dK/dV {times[0]:.4f} dQ "
                     f"{times[1]:.4f} ms")
        del q, k, v, do, out, lse, qs, delta, grads, args, masks
        torch.cuda.empty_cache()
    return lines


def child(csrc: Path, label: str, masked: bool) -> None:
    """Build the kernels from ``csrc`` and time the backward."""
    import torch
    sys.path.insert(0, str(ROOT))
    from xhy_flash_attention_tpu_torch.ops import _cuda
    _cuda.CSRC = csrc
    _cuda.BUILD_ROOT = csrc / "build"
    _cuda.lib()
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, fwd, fused_heads as fh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out_lines = []
    for shape, (b, h, hk, s, d) in (("T-long", (16, 16, 16, 2048, 64)),
                                    ("d128", (2, 32, 8, 2048, 128))):
        q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                 .bfloat16().transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(b, s, hk, d, generator=gen, device="cuda")
                .bfloat16().transpose(1, 2) for _ in range(2))
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        out, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
        err = ""
        if shape == "T-long":
            got = bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = bwd.attention_bwd_ref(q, k, v, out, lse, do, **kw)
            rel = max(((g.float() - w.float()).abs().max()
                       / w.float().abs().max()).item()
                      for g, w in zip(got, want))
            err = f", largest error / largest entry {rel:.3g}"
            del got, want
        qs, delta = bwd.flash_bwd_prep(q, out, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        args = (qs, k, v, do, lse, delta, *grads)
        prep = time_ms(lambda: bwd.flash_bwd_prep(q, out, do,
                                                  sm_scale=kw["sm_scale"]))
        dkv = time_ms(lambda: bwd.flash_bwd_dkv(*args, **kw))
        dq = time_ms(lambda: bwd.flash_bwd_dq(*args, **kw))
        whole = time_ms(lambda: bwd.flash_attention_bwd(q, k, v, out, lse,
                                                        do, **kw))
        out_lines.append(f"  [{label}] {shape}: whole {whole:.4f} ms (pre-pass "
                         f"{prep:.4f}, dK/dV {dkv:.4f}, dQ {dq:.4f}){err}")
        del q, k, v, do, out, lse, qs, delta, grads, args
        torch.cuda.empty_cache()
    b, s, h, d = 32, 1024, 16, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    q, k, v = fh._split(qkv, h, h, d)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    out, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
    dst = dict(zip(("dq", "dk", "dv"), fh._split(torch.empty_like(qkv), h, h,
                                                 d)))
    packed = time_ms(lambda: fh.fused_heads_bwd(q, k, v, out, lse, do, **kw,
                                                **dst))
    out_lines.append(f"  [{label}] T-packed: fused_heads_bwd {packed:.4f} ms")
    if masked:
        out_lines += masked_child(label)
    print("\n".join(out_lines), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--masked", action="store_true",
                    help="also time the masked kernels")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child), args.label, args.masked)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_bwd: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    dirs = {name: make_variant(name) for name in args.variants}
    order = args.variants + args.variants[::-1]
    failed = []
    for name in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", str(dirs[name]), "--label", name]
                              + ["--masked"] * args.masked)
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants failed: {sorted(set(failed))}")


if __name__ == "__main__":
    main()
