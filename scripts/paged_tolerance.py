#!/usr/bin/env python3
"""How the paged rows' check of chip_smoke.py sees a planted fault, on one
card.

    python3 scripts/paged_tolerance.py                  # every variant
    python3 scripts/paged_tolerance.py base skip-prefill-tile

Each variant is the kernel sources of ``xhy_flash_attention_tpu_torch/csrc``
with a text edit (``VARIANTS``), copied into
``xhy_flash_attention_tpu_torch/build/fault/<name>`` (ignored by git) and
built there, in a child process of its own. The faults drop interior keys
for the rows that see 4000 keys or more, that is the rows of the 4096-key
sequence: in the decode regime keys 1024-1087 (a 64-key tile) or 1024-1031
(one warp's share of it), in the prefill regime keys 1024-1151 (a 128-key
tile) or 1024-1039 (one 16-key step of its P.V). Each variant runs
the chunked entry at chip_smoke.py's phase-3 shapes (b8 h32 hk8 d128, pages
of 512, 8 per sequence, lengths 4096 ... 0; sq 1 and 512; bf16 and int8
pages) against the plain version, and prints for each row of the table the
verdict of two rules: one tolerance for the whole output (one bf16 unit of
its largest |out| plus 1e-3, the rule of the earlier check) and the
per-row rule of ``chip_smoke.row_excess`` (two bf16 units of the row's own
largest |out| plus 1e-4, capped by the first). Prints the card's name and
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
FAULT_ROOT = ROOT / "xhy_flash_attention_tpu_torch" / "build" / "fault"

# name -> [(file, old text, new text)]: each old text must occur once
VARIANTS = {
    "base": [],
    "skip-decode-tile": [
        ("decode_core.cuh",
         "x[e] = key >= lo_r[e >> 1] && key <= hi_r[e >> 1] ? s : -INFINITY;",
         "x[e] = key >= lo_r[e >> 1] && key <= hi_r[e >> 1] && (!kPaged || "
         "hi_r[e >> 1] < 4000 || key < 1024 || key >= 1088) ? s : -INFINITY;")],
    "skip-prefill-tile": [
        ("paged_decode.cu", "    s[i] = x;\n",
         "    s[i] = hi_r[(i >> 1) & 1] >= 4000 && n0 + c >= 1024 && "
         "n0 + c < 1152 ? -INFINITY : x;\n")],
    # smaller: one warp's 8 keys of a decode tile, one 16-key k-step of a
    # prefill tile's P.V
    "skip-decode-warp": [
        ("decode_core.cuh",
         "x[e] = key >= lo_r[e >> 1] && key <= hi_r[e >> 1] ? s : -INFINITY;",
         "x[e] = key >= lo_r[e >> 1] && key <= hi_r[e >> 1] && (!kPaged || "
         "hi_r[e >> 1] < 4000 || key < 1024 || key >= 1032) ? s : -INFINITY;")],
    "skip-prefill-kstep": [
        ("paged_decode.cu", "    s[i] = x;\n",
         "    s[i] = hi_r[(i >> 1) & 1] >= 4000 && n0 + c >= 1024 && "
         "n0 + c < 1040 ? -INFINITY : x;\n")],
}

CASES = [(dtype, sq) for sq in (1, 512) for dtype in ("bf16", "int8")]


def make_variant(name: str) -> Path:
    dst = FAULT_ROOT / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, old, new in VARIANTS[name]:
        path = dst / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {fname} has not one {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst


def child(csrc: Path, label: str) -> None:
    """Build the kernels from ``csrc`` and judge its paged outputs."""
    import torch
    sys.path.insert(0, str(ROOT))
    from xhy_flash_attention_tpu_torch.ops import _cuda
    _cuda.CSRC = csrc
    _cuda.BUILD_ROOT = csrc / "build"
    _cuda.lib()
    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch.inference import paged
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = cs.ENGINE_DECODE
    for dtype, sq in CASES:
        dt = torch.bfloat16 if dtype == "bf16" else torch.int8
        cache = cs._paged_sets(gen, dt, 512, 8, n_sets=1)[0]
        q = torch.randn(c["b"], sq, c["h"], c["d"], generator=gen,
                        device="cuda").bfloat16()
        out = paged.paged_flash_decode(q, cache)
        ref = paged.paged_flash_decode_ref(q, cache, c["d"] ** -0.5)
        err = cs.max_err(out, ref)
        tol = cs.BF16_ULP * ref.float().abs().max().item() + 1e-3
        excess = cs.row_excess(out, ref)
        long_err = cs.max_err(out[0], ref[0])  # the 4096-key sequence
        print(f"  [{label}] {dtype} sq {sq}: max_abs_err {err:.4g} (the "
              f"4096-key sequence's {long_err:.4g}); whole-output rule tol "
              f"{tol:.4g}: {'pass' if err <= tol else 'FAIL'}; per-row rule: "
              f"worst row at {excess:.4g} of its tolerance: "
              f"{'pass' if excess <= 1 else 'FAIL'}", flush=True)
        del cache, q, out, ref
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child), args.label)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_tolerance: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for name in args.variants:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", str(make_variant(name)),
                               "--label", name])
        failed += proc.returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
