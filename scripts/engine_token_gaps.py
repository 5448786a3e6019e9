#!/usr/bin/env python3
"""Greedy-token gaps of chip_smoke.py's engine run (phase 4b), by path of
the paged attention, on one card.

    python3 scripts/engine_token_gaps.py                     # int8 pages
    python3 scripts/engine_token_gaps.py --dtype bf16 --paths kernel plain
    python3 scripts/engine_token_gaps.py --root DIR          # another tree
    python3 scripts/engine_token_gaps.py --seeds 1 2 3       # other models

Builds chip_smoke.py's random Llama-3-8B-width model from each seed of
``--seeds`` (chip_smoke.py uses 0),
serves its 12 requests through ``InferenceEngine`` (pages of 512, chunked
prefill of 512) and prints, for each path, at how many generated tokens the
engine's greedy token differs from the argmax of one dense prefill over
prompt + generated tokens, and the largest gap (chip_smoke.py's
``check_engine_tokens``; phase 4b holds it to its near-tie bound). Paths:
``kernel`` (csrc/paged_decode.cu), ``plain`` (its plain version
``paged_flash_decode_ref`` in place of both paged entries; every other
kernel as it is), ``decode-kernel`` and ``prefill-kernel`` (the kernel
only for calls of its decode regime, sq * h / hk <= 16 rows per KV head,
or only for its prefill regime; the plain version for the others).
``--root`` imports chip_smoke.py and the package from another checkout,
for instance a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import types


@contextlib.contextmanager
def plain_paged(keep=None):
    """The paged entries routed to the plain version, except for calls of
    the regime ``keep`` ("decode" or "prefill"); restored on exit."""
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops.flash_attention.decode_kernel \
        import MAX_ROWS
    saved = (paged.paged_decode_chunked, paged.paged_decode_page)

    def call(q, cache, *, softmax_scale, window_size, softcap):
        rows = q.shape[1] * q.shape[2] // cache.kv_pages.shape[1]
        if ("decode" if rows <= MAX_ROWS else "prefill") == keep:
            return paged.launch_paged(q, cache, softmax_scale=softmax_scale,
                                      window_size=window_size, softcap=softcap)
        return paged.paged_flash_decode_ref(q, cache, softmax_scale,
                                            window_size, softcap)

    paged.paged_decode_chunked = paged.paged_decode_page = call
    try:
        yield
    finally:
        paged.paged_decode_chunked, paged.paged_decode_page = saved


PATHS = {"kernel": contextlib.nullcontext,
         "plain": plain_paged,
         "decode-kernel": lambda: plain_paged("decode"),
         "prefill-kernel": lambda: plain_paged("prefill")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--paths", nargs="+", choices=tuple(PATHS),
                    default=["kernel", "plain"])
    ap.add_argument("--root", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch import (
        GPTLMHeadModel, llama_config_to_gpt_config)

    if not torch.cuda.is_available():
        raise SystemExit("engine_token_gaps: no CUDA device")
    print(cs.card_line(), f"(tree {root})", flush=True)
    dtype = torch.int8 if args.dtype == "int8" else torch.bfloat16
    bound = cs.NEAR_TIE if dtype == torch.bfloat16 else cs.INT8_NEAR_TIE
    for seed in args.seeds:
        model = GPTLMHeadModel(
            llama_config_to_gpt_config(types.SimpleNamespace(**cs.LLAMA3_8B),
                                       torch.bfloat16), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed))
        for path in args.paths:
            reqs = cs._engine_requests(seed, model.config.vocab_size)
            eng = cs._timed_engine(model, dtype, **cs.ENGINE_RUN)
            for r in reqs:
                eng.add_request(r)
            with PATHS[path]():
                eng.run()
            try:
                cs.check_engine_tokens(
                    model, f"seed {seed}, {args.dtype} pages, {path} path",
                    reqs, bound)
            except AssertionError as e:
                print(f"  over the bound: {e}", flush=True)
            del eng
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
