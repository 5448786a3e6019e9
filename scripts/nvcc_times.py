#!/usr/bin/env python3
"""Time the compilation of each CUDA source of one or more checkouts.

    git archive HEAD~1 | tar -x -C archive_check/parent   # a directory git ignores
    python3 scripts/nvcc_times.py archive_check/parent .

For each tree, every source under xhy_flash_attention_tpu_torch/csrc (or
only those named with ``--sources``) is compiled with that tree's own
``_cuda.NVCC_FLAGS``, one ``nvcc`` process per source, all started
together, as ``_cuda.build`` runs them; the trees one after the other.
Prints each source's wall seconds and the tree's wall (the slowest
source), which is what a build adds to every call. The objects go to a
temporary directory and are discarded. Needs the CUDA toolkit, no card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def flags(root: Path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from xhy_flash_attention_tpu_torch.ops import _cuda; "
            "print(_cuda.nvcc()); print('\\x1f'.join(_cuda.NVCC_FLAGS))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], check=True,
                         capture_output=True, text=True, cwd=root)
    nvcc, joined = out.stdout.strip().splitlines()[-2:]
    return nvcc, joined.split("\x1f")


def time_tree(root: Path, only):
    nvcc, nvcc_flags = flags(root)
    csrc = root / "xhy_flash_attention_tpu_torch" / "csrc"
    srcs = [p for p in sorted(csrc.glob("*.cu")) if not only or p.name in only]
    with tempfile.TemporaryDirectory() as tmp:
        def one(src):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *nvcc_flags, "-I", str(csrc), "-c", str(src), "-o",
                 str(Path(tmp) / (src.stem + ".o"))],
                capture_output=True, text=True)
            return src.name, proc.returncode, time.perf_counter() - t0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
            got = list(ex.map(one, srcs))
        wall = time.perf_counter() - t0
    for name, rc, sec in got:
        print(f"{root}: {name}: {sec:.1f} s" + (f" (rc {rc})" if rc else ""),
              flush=True)
    print(f"{root}: wall {wall:.1f} s for {len(srcs)} sources", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--sources", nargs="*", default=None,
                    help="file names under csrc/ (default: all)")
    args = ap.parse_args()
    for root in args.roots:
        time_tree(Path(root).resolve(), set(args.sources or ()))


if __name__ == "__main__":
    main()
