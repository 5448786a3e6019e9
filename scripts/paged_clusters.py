#!/usr/bin/env python3
"""The decode regime of csrc/paged_decode.cu at each cluster size, forced,
on batches other than chip_smoke.py's ragged phase-3 row, on one card.

    python3 scripts/paged_clusters.py
    python3 scripts/paged_clusters.py --no-engine      # kernel rows only

1. Kernel rows at the engine's decode shape (b8 h32 hk8 d128, pages of 512,
   8 per sequence, bf16 and int8 pages): phase 3's ragged lengths 4096 ...
   0, and uniform batches of 8 sequences of 4096 keys (the capacity) and of
   2048. Each as CUDA graphs of calls (``chip_smoke.graph_ms``, three page
   tables rotated over disjoint pages), at clusters of 1, 2, 4 and 8 and at
   the plan's (``paged_launch_plan``).
2. Phase 6's engine step (chip_smoke.py's random Llama-3-8B-width model,
   32 layers, eight sequences of 64-2000 prompt tokens over bf16 pages,
   ``engine_vs_plain`` then ``profile_steps``): device ms of the
   ``paged_decode`` group per step and the step's wall ms, with the cluster
   forced through the plan, in turns (8, 4, 2, 1, 1, 2, 4, 8; the lengths
   grow by one a step).

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

CLUSTERS = (1, 2, 4, 8)


@contextlib.contextmanager
def forced_cluster(cluster):
    """paged_launch_plan with its cluster forced (None: the plan's own)."""
    from xhy_flash_attention_tpu_torch.inference import paged
    plan = paged.paged_launch_plan
    if cluster is not None:
        paged.paged_launch_plan = lambda *a: plan(*a[:7], cluster=cluster)
    try:
        yield
    finally:
        paged.paged_launch_plan = plan


def kernel_rows(gen):
    import torch

    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops import _cuda
    c = cs.ENGINE_DECODE
    b, h, hk, d = c["b"], c["h"], c["hk"], c["d"]
    plan = paged.paged_launch_plan(b, 1, h, hk, 512, 8, _cuda.sm_count(0))
    print(f"  plan: {json.dumps(plan)}", flush=True)
    for dtype in (torch.bfloat16, torch.int8):
        sets = cs._paged_sets(gen, dtype, 512, 8)
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
        for name, lengths in (("ragged 4096 ... 0", c["lengths"]),
                              ("uniform 8 x 4096", [4096] * b),
                              ("uniform 8 x 2048", [2048] * b)):
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            caches = [dataclasses.replace(s, lengths=lens) for s in sets]
            ms = {str(cl): cs.graph_ms([lambda s=s, cl=cl: paged.launch_paged(
                q, s, softmax_scale=d ** -0.5, cluster=cl) for s in caches])
                for cl in CLUSTERS}
            ms["plan"] = cs.graph_ms([lambda s=s: paged.paged_flash_decode(
                q, s) for s in caches])
            print(f"  {cs.SHORT[dtype]} pages, {name}: graph ms by cluster "
                  f"{json.dumps(ms)}", flush=True)
        del sets, caches, q
        torch.cuda.empty_cache()


def engine_step(seed):
    import types

    import torch

    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, llama_config_to_gpt_config)
    model = GPTLMHeadModel(
        llama_config_to_gpt_config(types.SimpleNamespace(**cs.LLAMA3_8B),
                                   torch.bfloat16), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    eng = cs.engine_vs_plain(model, torch.bfloat16, seed)
    active = [r for r in eng.slots if r is not None]
    eng._decode_step(active)
    res = {}
    for cl in (8, 4, 2, 1, 1, 2, 4, 8):
        with forced_cluster(cl):
            eng._decode_step(active)  # warm-up at this size
            out = cs.profile_steps(lambda: eng._decode_step(active), 6,
                                   {"cluster": cl})
        res.setdefault(cl, []).append(
            (out["device_ms_per_step"].get("paged_decode", 0.0),
             out["wall_ms_per_step_profiled"], out["device_idle_share"]))
    for cl in CLUSTERS:
        print(f"  engine step, cluster {cl}: paged_decode ms / step "
              f"{[round(r[0], 4) for r in res[cl]]}, step wall ms "
              f"{[round(r[1], 2) for r in res[cl]]}, idle share "
              f"{[round(r[2], 3) for r in res[cl]]} (two turns; lengths "
              f"{eng._lengths.tolist()} at the end)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-engine", action="store_true")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("paged_clusters: no CUDA device")
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernel_rows(gen)
    if not args.no_engine:
        engine_step(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
