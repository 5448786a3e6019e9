#!/usr/bin/env python3
"""Error of the paged attention against exact attention, by path, on one
card.

    python3 scripts/paged_error.py [--sq 1] [--seed 0]

At the engine's decode shape (b8 h32 hk8 d128, pages of 512, 8 per
sequence, lengths 4096 ... 0), for bf16 and int8 pages: the output of
csrc/paged_decode.cu (each cluster size forced) and of its plain version
``paged_flash_decode_ref``, each against fp64 attention over the same
(dequantized) keys and values with P unrounded. Prints, per path, the
largest and the rms error and the mean signed error (a bias), over the
rows that see a key, in units of one bf16 step of the largest output.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def exact(q, cache, scale):
    """fp64 attention over the pages gathered and dequantized."""
    import torch
    from xhy_flash_attention_tpu_torch.inference import paged
    k, v, ks, vs = paged._gather(cache)
    k, v = k.double(), v.double()
    if ks is not None:
        k, v = k * ks[..., None].double(), v * vs[..., None].double()
    b, sq, h, d = q.shape
    hk, S = k.shape[1], k.shape[2]
    g = h // hk
    qr = q.double().reshape(b, sq, hk, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hk, sq * g, d)
    s = torch.einsum("bhrd,bhtd->bhrt", qr, k) * scale
    pos = cache.lengths.long()[:, None] - sq + torch.arange(
        sq * g, device=q.device) // g
    mask = torch.arange(S, device=q.device)[None, None] <= pos[:, :, None]
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    o = torch.einsum("bhrt,bhtd->bhrd", p, v)
    return o.reshape(b, hk, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sq", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch.inference import paged
    from xhy_flash_attention_tpu_torch.ops.flash_attention.decode_kernel import \
        CLUSTER_SIZES

    if not torch.cuda.is_available():
        raise SystemExit("paged_error: no CUDA device")
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    c = cs.ENGINE_DECODE
    d = c["d"]
    for dtype in (torch.bfloat16, torch.int8):
        cache = cs._paged_sets(gen, dtype, 512, 8, n_sets=1)[0]
        q = torch.randn(c["b"], args.sq, c["h"], d, generator=gen,
                        device="cuda").bfloat16()
        want = exact(q, cache, d ** -0.5)
        seen = cache.lengths > 0
        unit = cs.BF16_ULP * want.abs().max().item()
        outs = {"plain": paged.paged_flash_decode_ref(q, cache, d ** -0.5)}
        for cl in CLUSTER_SIZES:
            outs[f"kernel, cluster {cl}"] = paged.launch_paged(
                q, cache, softmax_scale=d ** -0.5, cluster=cl)
        for name, out in outs.items():
            e = (out.double() - want)[seen]
            print(f"  {cs.SHORT[dtype]} pages, sq {args.sq}, {name}: max "
                  f"{e.abs().max().item() / unit:.4f}, rms "
                  f"{e.square().mean().sqrt().item() / unit:.4f}, mean "
                  f"{e.mean().item() / unit:+.5f} (bf16 steps of max|out| "
                  f"{unit:.4g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
