#!/usr/bin/env python3
"""A/B timing of the fp32 backward's design choices (csrc/flash_fp32.cu) on
one card.

    python3 scripts/ab_fp32_bwd.py                 # every variant
    python3 scripts/ab_fp32_bwd.py base rna         # some of them

Each variant is the kernel sources of ``xhy_flash_attention_tpu_torch/csrc``
with a few text edits (``VARIANTS``), copied into
``xhy_flash_attention_tpu_torch/build/ab_fp32/<name>`` (ignored by git).
The other sources are compiled once and each variant's flash_fp32.cu is
linked with them. Each variant runs in a child process of its own: the
dK/dV and dQ kernels at G's attention (b4 h25 s896 d64 causal), at
T-packed's (b32 h16 s1024 d64 causal) and at d 128 (b2 h32 hk8 s2048
causal), with CUDA events after a warm-up, and the largest error of the
three gradients at G against the fp32 plain backward, over the largest
entry (the probes' results are wrong by design: timing only). The
variants run in turns, first to last and then last to first. Prints the
card's name and power limit first, and each variant's functions that
spill.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
AB_ROOT = ROOT / "xhy_flash_attention_tpu_torch" / "build" / "ab_fp32"

_RNA = ('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
        "  const float d = x - __uint_as_float(hi);\n")
# name -> [(file, old text, new text)]: each old text must occur in the file
VARIANTS = {
    "base": [],
    # the split rounded (cvt.rna.tf32.f32) instead of truncated: the hi of
    # the register operands and the lo everywhere (the shared-memory hi
    # stays raw, so the results are off: timing only)
    "rna": [
        ("hopper.cuh", "  hi = __float_as_uint(x);\n  lo = __float_as_uint(tf32_lo(x));",
         _RNA + '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(d));'),
        ("hopper.cuh", "  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);",
         '  uint32_t h;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));\n'
         "  return x - __uint_as_float(h);")],
    # rna, with lo set to 0 for a value that is not finite
    "rna_finite": [
        ("hopper.cuh", "  hi = __float_as_uint(x);\n  lo = __float_as_uint(tf32_lo(x));",
         _RNA + '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(d));\n'
         "  lo = isfinite(x) ? lo : 0u;"),
        ("hopper.cuh", "  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);",
         '  uint32_t h;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));\n'
         "  return isfinite(x) ? x - __uint_as_float(h) : 0.f;")],
    # four k-steps a wait at d 64 (eight in the kernel)
    "chunk4": [("flash_fp32.cu", "constexpr int kChunk = D == 64 ? 8 : 2;",
                "constexpr int kChunk = D == 64 ? 4 : 2;")],
    # probes (wrong results): the converters write nothing; P = S, dS = dP
    "noconv": [("flash_fp32.cu", "    if (j < kItems) {",
                "    if (ct >= 0) break;\n    if (j < kItems) {")],
    "noelem": [("flash_fp32.cu",
                "  pr = vis ? sm90::ex2(fmaf(x, sm90::kLog2e, -lse2)) : 0.f;\n"
                "  dp = pr * (dp - delta) * fac;",
                "  pr = x;\n  dp = dp * fac;")],
}

SHAPES = (("G", dict(b=4, h=25, hk=25, s=896, d=64)),
          ("T-packed", dict(b=32, h=16, hk=16, s=1024, d=64)),
          ("d128", dict(b=2, h=32, hk=8, s=2048, d=128)))


def build(names) -> None:
    from xhy_flash_attention_tpu_torch.ops import _cuda
    objs = AB_ROOT / "_objs"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda.nvcc()
    procs = [subprocess.Popen([nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-c",
                               str(src), "-o", str(objs / (src.stem + ".o"))],
                              stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
             for src in _cuda.sources() if src.name != "flash_fp32.cu"]
    for name in names:
        dst = AB_ROOT / name
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(_cuda.CSRC, dst / "csrc")
        for fname, old, new in VARIANTS[name]:
            path = dst / "csrc" / fname
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: {fname} has no {old[:60]!r}")
            path.write_text(text.replace(old, new))
        procs.append(subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-I", str(dst / "csrc"), "-c",
             str(dst / "csrc" / "flash_fp32.cu"), "-o", str(dst / "flash_fp32.o")],
            stdout=open(dst / "build.log", "w"), stderr=subprocess.STDOUT))
    for proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed: {proc.args[-3]}")
    for name in names:
        dst = AB_ROOT / name
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                        str(dst / "lib.so"), str(dst / "flash_fp32.o"),
                        *map(str, sorted(objs.glob("*.o")))], check=True)
        spills = re.findall(r"(\d+) bytes spill stores", (dst / "build.log").read_text())
        print(f"{name}: {sum(s != '0' for s in spills)} functions spill", flush=True)


def child(name: str) -> None:
    import torch
    from xhy_flash_attention_tpu_torch.ops import _cuda
    _cuda.build = lambda verbose=False: AB_ROOT / name / "lib.so"
    _cuda.lib()
    from xhy_flash_attention_tpu_torch.ops.flash_attention import bwd, fwd
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for label, sh in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(sh["b"], sh["s"], n, sh["d"], generator=gen,
                                   device="cuda").transpose(1, 2)
                       for n in (sh["h"], sh["hk"], sh["hk"], sh["h"]))
        kw = dict(sm_scale=sh["d"] ** -0.5, causal=True, softcap=0.0)
        o, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        kw32 = dict(sm_scale=kw["sm_scale"], window=(-1, 0), softcap=0.0)
        times = []
        for fn in (bwd.flash_bwd_dkv_fp32, bwd.flash_bwd_dq_fp32):
            for _ in range(3):
                fn(qs, k, v, do, lse, delta, *grads, **kw32)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(10):
                fn(qs, k, v, do, lse, delta, *grads, **kw32)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 10)
        line = f"{label} dK/dV {times[0]:.4f} dQ {times[1]:.4f} ms"
        if label == "G":
            want = bwd.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            err = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(grads, want))
            line += f" (error / largest entry {err:.3g})"
        out.append(line)
        del q, k, v, do, o, lse, qs, delta, grads
        torch.cuda.empty_cache()
    print(f"  [{name}] " + "; ".join(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_fp32_bwd: no CUDA device")
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build(args.variants)
    failed = []
    for name in args.variants + args.variants[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name],
                              cwd=ROOT)
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants failed: {sorted(set(failed))}")


if __name__ == "__main__":
    main()
