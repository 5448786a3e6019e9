#!/usr/bin/env python3
"""Compare the attention kernels' machine code of two checkouts.

    git archive HEAD~1 | tar -x -C archive_check/parent   # a directory git ignores
    python3 scripts/sass_diff.py archive_check/parent .

Builds each tree's kernels (its own build directory, in a child process
with that tree's package) unless built, then for every instantiation of
`flash_fwd_kernel`, `flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`,
`flash_bwd_dbias_kernel`, `flash_bwd_prep_kernel`, `flash_decode_kernel`,
`paged_decode_kernel`, `paged_prefill_kernel`, `reduced_scores_kernel` and
the fp32 kernels of flash_fp32.cu prints, per tree, the ptxas report's
registers
and spills and the SASS instruction count (`cuobjdump -sass`), and whether
the opcode streams of the two trees are the same (operands, addresses and
constants ignored), else how many opcodes a diff of the two streams
changes. A kernel that gained trailing template arguments (the bias flag
of the attention kernels, the forward's e4m3 flag, the pre-pass's input
type, the fused norm's rowscale, colscale and dropout flags) is matched
with its instantiation at the old behaviour: an instantiation `<...,
false>` (`<..., false, false, false>`) or `<..., __nv_bfloat16>` of the
second tree stands beside `<...>` of the first when the first has no such
name. The fused norm's kernels (`ln_fwd_kernel`, `ln_bwd_kernel`, every
flag instantiation) must spill nothing, else the script exits non-zero. The
last line counts the pairs with the same opcodes and those that differ. Last, the second tree's
e4m3 instantiations of the forward (`flash_fwd_kernel<D, false, false,
true>`) by tensor-core product: their QK^T must be `QGMMA` (e4m3), else
the script exits non-zero; and the second tree's fp32 kernels, dense and
MASKED, with and without BIAS (`flash_fwd_fp32_kernel`,
`flash_bwd_dkv_fp32_kernel`, `flash_bwd_dq_fp32_kernel`), the fp32 dbias
kernel (`flash_bwd_dbias_fp32_kernel`) and the fp32 reduced scores
(`reduced_scores_fp32_kernel`): each must issue `HGMMA ... TF32` and spill
nothing, else the script exits non-zero.
Needs the CUDA toolkit (nvcc, cuobjdump) and no card.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from pathlib import Path

KERNELS = re.compile(r"(flash_(fwd|bwd_dkv|bwd_dq|bwd_dbias)(_fp32)?|flash_bwd_prep"
                     r"|flash_decode|paged_decode|paged_prefill"
                     r"|reduced_scores(_fp32)?|ln_(fwd|bwd))_kernel<[^>]*>")
LN = re.compile(r"ln_(fwd|bwd)_kernel<[^>]*>")
# trailing template arguments a kernel gained, at the old behaviour
OLD_BEHAVIOUR = (", false>", ", __nv_bfloat16>")
E4M3 = re.compile(r"flash_fwd_kernel<\d+, false, false, true>")
FP32_TF32 = re.compile(r"(flash_(fwd|bwd_dkv|bwd_dq|bwd_dbias)|reduced_scores)_fp32_kernel"
                       r"<[^>]*>")


def matched(first, second):
    """{name in the second tree: its name in the first}: the same name, or
    the name without trailing OLD_BEHAVIOUR arguments (one or more, as the
    norm's three flags) that the first lacks."""
    out = {}
    for name in second:
        base = name
        while base not in first:
            tail = next((t for t in OLD_BEHAVIOUR if base.endswith(t)), None)
            if tail is None:
                break
            base = base[:-len(tail)] + ">"
        out[name] = base if base in first else name
    return out


def build(root: Path) -> Path:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from xhy_flash_attention_tpu_torch.ops import _cuda; "
            "print(_cuda.build())")
    out = subprocess.run([sys.executable, "-c", code, str(root)], check=True,
                         capture_output=True, text=True, cwd=root)
    return Path(out.stdout.strip().splitlines()[-1])


def demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def ptxas(lib: Path):
    """{kernel: "registers, spills"} from the build's ptxas report."""
    log = (lib.parent / "build.log").read_text()
    cur, regs, out = None, None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur] = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = out.get(cur, "") + f", {m.group(1)} registers"
    names = list(out)
    return {KERNELS.search(d).group(0): out[n]
            for n, d in zip(names, demangle(names)) if KERNELS.search(d)}


def sass(lib: Path):
    """({kernel: [opcodes]}, {kernel: HGMMA instructions on TF32}) of the
    library's SASS."""
    txt = subprocess.run(["cuobjdump", "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, tf32, cur = {}, {}, None
    for line in txt.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur], tf32[cur] = [], 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur and m:
            funcs[cur].append(m.group(2))
            tf32[cur] += m.group(2).startswith("HGMMA") and "TF32" in line
    names = list(funcs)
    found = [(KERNELS.search(d), n) for n, d in zip(names, demangle(names))]
    return ({k.group(0): funcs[n] for k, n in found if k},
            {k.group(0): tf32[n] for k, n in found if k})


def main():
    roots = [Path(r).resolve() for r in sys.argv[1:]]
    if len(roots) != 2:
        raise SystemExit("give two tree roots")
    libs = [build(r) for r in roots]
    reports = [ptxas(lib) for lib in libs]
    codes, tf32 = zip(*(sass(lib) for lib in libs))
    pairs = matched(codes[0], codes[1])
    pairs.update({n: n for n in codes[0] if n not in pairs.values()})
    tally = {"same": 0, "differ": 0, "new": 0}
    for name in sorted(pairs):
        old = pairs[name]
        a, b = codes[0].get(old), codes[1].get(name)
        same = "same opcodes"
        tally["same" if a == b else "new" if a is None else "differ"] += 1
        if a != b:
            ops = difflib.SequenceMatcher(None, a or [], b or [],
                                          autojunk=False).get_opcodes()
            changed = sum(max(i2 - i1, j2 - j1)
                          for tag, i1, i2, j1, j2 in ops if tag != "equal")
            same = f"{changed} opcodes differ"
        label = name if old == name else f"{old} -> {name}"
        print(f"{label}: {len(a) if a else None} / {len(b) if b else None} "
              f"instructions, {same}; {reports[0].get(old)} | "
              f"{reports[1].get(name)}", flush=True)
    print(f"pairs with the same opcodes: {tally['same']}; differing: "
          f"{tally['differ']}; only in the second tree: {tally['new']}",
          flush=True)
    for name, ops in sorted(codes[1].items()):
        if E4M3.fullmatch(name):
            kinds = {k: sum(op.startswith(k) for op in ops)
                     for k in ("QGMMA", "HGMMA")}
            print(f"{name}: {kinds}", flush=True)
            if not kinds["QGMMA"]:
                raise SystemExit(f"{name} has no QGMMA")
    for name in sorted(codes[1]):
        if FP32_TF32.fullmatch(name):
            report = reports[1].get(name) or ""
            print(f"{name}: {tf32[1][name]} HGMMA on TF32; {report}", flush=True)
            if not tf32[1][name]:
                raise SystemExit(f"{name} issues no TF32 HGMMA")
            if "spills 0/0 B" not in report:
                raise SystemExit(f"{name} spills: {report}")
    for name in sorted(codes[1]):
        if LN.fullmatch(name):
            report = reports[1].get(name) or ""
            print(f"{name}: {report}", flush=True)
            if "spills 0/0 B" not in report:
                raise SystemExit(f"{name} spills: {report}")


if __name__ == "__main__":
    main()
