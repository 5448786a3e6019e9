#!/usr/bin/env python3
"""Time the same attention calls in two or more checkouts of the
repository, in turns, on one card.

    git archive HEAD~1 | tar -x -C archive_check/parent   # a directory git ignores
    python3 scripts/ab_trees.py archive_check/parent .     # parent, change, change, parent

Each tree runs in a child process of its own with that tree's package and
its ``chip_smoke.py`` helpers (its kernels built into its own build
directory), on the same seeded data: the dense forward at request A's
shape (b2 h32 hk8 s2048 d128 causal) and at T-long's (b16 h16 s2048 d64
causal); the dense backward at both shapes, whole (``flash_attention_bwd``)
and by kernel (pre-pass, dK/dV, dQ); the packed backward (#6) at
T-packed's shape (b32 s1024 h16 d64 causal); under chip_smoke.py's FM-doc,
BS and FM-swg masks the forward through ``flash_attention_fwd`` and the
masked dK/dV and dQ kernels; the reduced scores at FM-swg's shape; in
trees whose chip_smoke.py has them, the forward, dK/dV and dQ kernels
under SW's window and VL-doc's segment ids and positions (the mask
arguments made once); in trees whose chip_smoke.py has phase 14, the
forward, dK/dV, dQ and dbias kernels with an attention bias at its cases
(``--bias-only``: those alone); in trees whose chip_smoke.py has phase 15,
the fp8 forward (``flash_attn_fp8_func``) at its timed cases
(``--fp8-only``: those alone); with ``--dropout-only``, the dropout
instantiations of the forward, dK/dV and dQ kernels (p 0.1, dense at A's
and T-long's shapes, masked under FM-doc's causal document FlashMask),
each beside the same kernel without dropout; with ``--fp32-only``, the fp32 kernels
alone (csrc/flash_fp32.cu): the forward at G's shape (b4 h25 s896 d64
causal, through ``flash_attention_fwd``), at T-packed's (b32 s1024 h16
d64 causal, through ``fused_heads_fwd`` on the packed layout) and on
fp32 pages at G's engine chunk (b8 h25 d64, sq 512, pages of 512, through
``paged_flash_decode``), each as CUDA graphs of calls (chip_smoke.py
graph_ms) with SDPA's fp32 forward beside the first two; the backward
(dK/dV and dQ after the pre-pass) at G's shape (whole through
``flash_attention_bwd``, the pre-pass and each kernel) and at T-packed's
(whole through ``fused_heads_bwd`` on the packed layout, and each kernel
on its strides), with SDPA's fp32 backward beside each (TF32 off); in
trees whose chip_smoke.py has phase 3's masked fp32 rows, the masked fp32
forward, dK/dV and dQ at FM-doc, BS, FM-swg and VL-doc in fp32 (the mask
arguments made once). CUDA events after a warm-up. The trees
run first to last, then last to first. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path


def bias_rows(cs, bwd, fwd, timed):
    """The bias rows of phase 14's cases: the forward with the bias, the
    dK/dV and dQ kernels with it, the dbias kernel."""
    import torch
    for label, shape, kind in cs.BIAS_CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, h, hk, s, d = cs._dims(shape)
        q, k, v, do = cs._sparse_inputs(gen, shape)
        bias = torch.randn(cs.bias_shape(kind, b, h, s), generator=gen,
                           device="cuda")
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        timed(f"bias fwd {label}", lambda: fwd.flash_attention_fwd(
            q, k, v, bias, need_lse=True, **kw))
        o, lse = fwd.flash_attention_fwd(q, k, v, bias, need_lse=True, **kw)
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for which, fn in (("dkv", bwd.flash_bwd_dkv), ("dq", bwd.flash_bwd_dq)):
            timed(f"bias {which} {label}", lambda fn=fn: fn(
                qs, k, v, do, lse, delta, *grads, bias=bias, **kw), iters=10)
        timed(f"bias dbias {label}", lambda: bwd.flash_bwd_dbias(
            qs, k, v, do, lse, delta, bias, causal=True, softcap=0.0),
            iters=10)
        del q, k, v, do, o, lse, qs, delta, grads, bias
        torch.cuda.empty_cache()


def fp8_rows(cs, timed):
    """The fp8 forward at phase 15's timed cases, on its quantized inputs."""
    import torch
    from xhy_flash_attention_tpu_torch import flash_attn_fp8_func
    for label, (shape, kw) in cs.FP8_CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = cs.fp8_inputs(gen, *shape)
        timed(f"fp8 {label}", lambda: flash_attn_fp8_func(
            *x, return_lse=True, **kw))
        del x
        torch.cuda.empty_cache()


def dropout_rows(cs, bwd, common, fwd, timed):
    """The forward, dK/dV and dQ kernels with dropout p 0.1 and without
    it: dense at A and T-long, masked under FM-doc's document mask."""
    import torch
    drop = common.Dropout(0.1, 1234)
    for name, shape, flags in (
            ("A", cs.T_GQA, lambda g, b, s: {}),
            ("T-long", cs.T_LONG, lambda g, b, s: {}),
            ("FM-doc", cs.FM_DOC, lambda g, b, s: cs._flags(
                cs.doc_indices(g, b, s), causal=True))):
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, h, hk, s, d = cs._dims(shape)
        q, k, v, do = cs._sparse_inputs(gen, shape)
        eff, masks = fwd.build_masks(b, h, s, s, True, **flags(gen, b, s))
        kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0, masks=masks)
        o, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
        dst = torch.empty_like(o)
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for tag, dr in (("dropout", drop), ("none", None)):
            timed(f"fwd {tag} {name}", lambda dr=dr: fwd.launch_flash_fwd(
                q, k, v, dst, lse, dropout=dr, **kw))
            for which, fn in (("dkv", bwd.flash_bwd_dkv),
                              ("dq", bwd.flash_bwd_dq)):
                timed(f"{which} {tag} {name}", lambda fn=fn, dr=dr: fn(
                    qs, k, v, do, lse, delta, *grads, dropout=dr, **kw),
                    iters=10)
        del q, k, v, do, o, lse, dst, qs, delta, grads, masks
        torch.cuda.empty_cache()


def fp32_fwd_rows(cs, fh, fwd, out):
    """The fp32 forward at G's and T-packed's shapes (SDPA fp32 beside)
    and on fp32 pages at G's engine chunk, as CUDA graphs of calls."""
    import torch
    from xhy_flash_attention_tpu_torch.inference import paged
    for name, packed in (("G", False), ("T-packed", True)):
        shape = cs.G_ATTN if name == "G" else cs.T_PACKED
        b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        if packed:
            qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                              device="cuda")
            q, k, v = fh._split(qkv, h, hk, d)
            ms = cs.graph_ms([lambda: fh.fused_heads_fwd(
                q, k, v, need_lse=True, **kw)], reps=4, replays=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        else:
            qt, kt, vt, _ = cs._fp32_inputs(gen, shape)
            ms = cs.graph_ms([lambda: fwd.flash_attention_fwd(
                qt, kt, vt, need_lse=True, **kw)], reps=4, replays=5)
        sdpa = cs.graph_ms([lambda: cs._sdpa_fp32(qt, kt, vt)], reps=4,
                           replays=5)
        out.append(f"fp32 fwd {name} {ms:.4f}; fp32 sdpa fwd {name} "
                   f"{sdpa:.4f}")
        del qt, kt, vt
        torch.cuda.empty_cache()
    c = cs.G_ENGINE_DECODE
    b, h, hk, d, sq, ps = c["b"], c["h"], c["hk"], c["d"], 512, 512
    npp = (max(c["lengths"]) + ps - 1) // ps
    gen = torch.Generator(device="cuda").manual_seed(0)
    kv = torch.randn(3 * b * npp + 1, hk, 2, ps, d, generator=gen,
                     device="cuda")
    perm = torch.randperm(3 * b * npp, generator=gen, device="cuda").to(
        torch.int32)
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
    caches = [paged.PagedKVCache(kv, perm[i * b * npp:(i + 1) * b * npp]
                                 .reshape(b, npp).contiguous(), lengths)
              for i in range(3)]
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda")
    ms = cs.graph_ms([lambda cache=cache: paged.paged_flash_decode(q, cache)
                      for cache in caches])
    out.append(f"fp32 paged prefill G chunk {ms:.4f}")
    del kv, caches, q
    torch.cuda.empty_cache()


def fp32_rows(cs, bwd, fh, fwd, timed, out):
    """The fp32 forward (fp32_fwd_rows), then the fp32 backward at G's and
    T-packed's shapes: whole, pre-pass, dK/dV and dQ, and SDPA's fp32
    backward (forward and backward minus forward)."""
    import torch
    fp32_fwd_rows(cs, fh, fwd, out)
    for name, packed in (("G", False), ("T-packed", True)):
        shape = cs.G_ATTN if name == "G" else cs.T_PACKED
        b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        if packed:
            qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=gen,
                              device="cuda")
            q, k, v = fh._split(qkv, h, hk, d)
            do = torch.randn(b, s, h, d, generator=gen, device="cuda")
            o, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
            dst = dict(zip(("dq", "dk", "dv"),
                           fh._split(torch.empty_like(qkv), h, hk, d)))
            timed(f"fp32 bwd whole {name}", lambda: fh.fused_heads_bwd(
                q, k, v, o, lse, do, **kw, **dst), iters=10)
            qt, kt, vt, dot, ot = (t.transpose(1, 2) for t in (q, k, v, do, o))
            grads = [dst[n].transpose(1, 2) for n in ("dq", "dk", "dv")]
        else:
            qt, kt, vt, dot = cs._fp32_inputs(gen, shape)
            ot, lse = fwd.flash_attention_fwd(qt, kt, vt, need_lse=True, **kw)
            timed(f"fp32 bwd whole {name}", lambda: bwd.flash_attention_bwd(
                qt, kt, vt, ot, lse, dot, **kw), iters=10)
            grads = [torch.empty_like(t) for t in (qt, kt, vt)]
        timed(f"fp32 prep {name}", lambda: bwd.flash_bwd_prep(
            qt, ot, dot, sm_scale=kw["sm_scale"]))
        qs, delta = bwd.flash_bwd_prep(qt, ot, dot, sm_scale=kw["sm_scale"])
        kw32 = dict(sm_scale=kw["sm_scale"], window=(-1, 0), softcap=0.0)
        for which, fn in (("dkv", bwd.flash_bwd_dkv_fp32),
                          ("dq", bwd.flash_bwd_dq_fp32)):
            timed(f"fp32 {which} {name}", lambda fn=fn: fn(
                qs, kt, vt, dot, lse, delta, *grads, **kw32), iters=10)
        out.append(f"fp32 sdpa bwd {name} {cs._sdpa_bwd_ms(qt, kt, vt, dot):.4f}")
        del qt, kt, vt, dot, ot, lse, qs, delta, grads
        torch.cuda.empty_cache()
    if hasattr(cs, "fp32_masked_kernels"):
        fp32_masked_rows(cs, bwd, fwd, timed)


def fp32_masked_rows(cs, bwd, fwd, timed):
    """The masked fp32 kernels (forward, dK/dV, dQ) at phase 3's FM-doc,
    BS, FM-swg and VL-doc shapes in fp32, the mask arguments made once."""
    import torch
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    cases = (
        ("FM-doc-fp32", cs.FM_DOC, True,
         lambda g, b, s: cs._flags(cs.doc_indices(g, b, s), causal=True)),
        ("BS-fp32", cs.BS, False,
         lambda g, b, s: cs._flags(block_mask=cs.bigbird_mask(
             g, b, s // cs.BS_BLOCK))),
        ("FM-swg-fp32", cs.FM_SWG, True,
         lambda g, b, s: cs._flags(global_sliding_window_mask(
             b, s, cs.SWG_WINDOW, cs.SWG_GLOBAL), causal=True)),
        ("VL-doc-fp32", cs.VL_DOC, True,
         lambda g, b, s: cs.vl_flags(*(cs.doc_cu_seqlens(
             g, s, *cs.VL_DOC_LENGTHS),) * 2, s, s)))
    for label, shape, causal, make in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, h, hk, s, d = cs._dims(shape)
        q, k, v, do = cs._sparse_inputs(gen, shape, torch.float32)
        eff, masks = fwd.build_masks(b, h, s, s, causal, **make(gen, b, s))
        kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
        o, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, masks=masks,
                                         **kw)
        timed(f"fp32 masked fwd {label}", lambda: fwd.launch_flash_fwd(
            q, k, v, o, None, masks=masks, **kw))
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        kw32 = dict(sm_scale=kw["sm_scale"], window=fwd.fp32_window(masks, eff),
                    softcap=0.0, masks=masks, causal=eff)
        for which, fn in (("dkv", bwd.flash_bwd_dkv_fp32),
                          ("dq", bwd.flash_bwd_dq_fp32)):
            timed(f"fp32 masked {which} {label}", lambda fn=fn: fn(
                qs, k, v, do, lse, delta, *grads, **kw32), iters=10)
        del q, k, v, do, o, lse, qs, delta, grads, masks
        torch.cuda.empty_cache()


def child(root: Path, only: str = "") -> None:
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    from xhy_flash_attention_tpu_torch.ops import _cuda
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        bwd, common, fused_heads as fh, fwd, reduced_scores as rs)
    assert Path(_cuda.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    out = []

    def timed(label, fn, iters=20):
        out.append(f"{label} {cs.time_ms([fn], iters=iters):.4f}")

    if only:
        if only == "bias":
            bias_rows(cs, bwd, fwd, timed)
        elif only == "fp8":
            fp8_rows(cs, timed)
        elif only == "dropout":
            dropout_rows(cs, bwd, common, fwd, timed)
        else:
            fp32_rows(cs, bwd, fh, fwd, timed, out)
        print(f"{root}: " + "; ".join(out), flush=True)
        return
    for name, (b, h, hk, s, d) in (("A", (2, 32, 8, 2048, 128)),
                                   ("T-long", (16, 16, 16, 2048, 64))):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = cs._sparse_inputs(gen, dict(b=b, h=h, hk=hk, s=s, d=d))
        kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
        timed(f"fwd {name}", lambda: fwd.flash_attention_fwd(
            q, k, v, need_lse=False, **kw))
        o, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw)
        timed(f"bwd whole {name}", lambda: bwd.flash_attention_bwd(
            q, k, v, o, lse, do, **kw), iters=10)
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        timed(f"prep {name}", lambda: bwd.flash_bwd_prep(
            q, o, do, sm_scale=kw["sm_scale"]))
        for which, fn in (("dkv", bwd.flash_bwd_dkv), ("dq", bwd.flash_bwd_dq)):
            timed(f"{which} {name}", lambda fn=fn: fn(
                qs, k, v, do, lse, delta, *grads, **kw), iters=10)
        del q, k, v, do, o, lse, qs, delta, grads
        torch.cuda.empty_cache()
    b, s, h, d = 32, 1024, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    q, k, v = fh._split(qkv, h, h, d)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=0.0)
    o, lse = fh.fused_heads_fwd(q, k, v, need_lse=True, **kw)
    dst = dict(zip(("dq", "dk", "dv"),
                   fh._split(torch.empty_like(qkv), h, h, d)))
    timed("bwd packed T-packed", lambda: fh.fused_heads_bwd(
        q, k, v, o, lse, do, **kw, **dst), iters=10)
    del qkv, do, q, k, v, o, lse, dst
    torch.cuda.empty_cache()
    cases = (
        ("FM-doc", cs.FM_DOC, True,
         lambda g, b, s: cs._flags(cs.doc_indices(g, b, s), causal=True)),
        ("BS", cs.BS, False,
         lambda g, b, s: cs._flags(block_mask=cs.bigbird_mask(
             g, b, s // cs.BS_BLOCK))),
        ("FM-swg", cs.FM_SWG, True,
         lambda g, b, s: cs._flags(global_sliding_window_mask(
             b, s, cs.SWG_WINDOW, cs.SWG_GLOBAL), causal=True)))
    for name, shape, causal, make in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, h, hk, s, d = cs._dims(shape)
        q, k, v, do = cs._sparse_inputs(gen, shape)
        flags = make(gen, b, s)
        kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0)
        timed(f"masked fwd {name}", lambda: fwd.flash_attention_fwd(
            q, k, v, need_lse=False, **kw, **flags))
        o, lse = fwd.flash_attention_fwd(q, k, v, need_lse=True, **kw, **flags)
        masks = common.KernelMasks(b, h, s, s, **flags)
        qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for which, fn in (("dkv", bwd.flash_bwd_dkv), ("dq", bwd.flash_bwd_dq)):
            timed(f"masked {which} {name}", lambda fn=fn: fn(
                qs, k, v, do, lse, delta, *grads, masks=masks, **kw), iters=10)
        if name == "FM-swg":
            timed("reduced FM-swg", lambda: rs.calc_reduced_attn_scores(
                q, k, lse, causal=True))
        del q, k, v, do, o, lse, qs, delta, grads, masks
        torch.cuda.empty_cache()
    if hasattr(cs, "SW"):
        s = cs.VL_DOC["s"]
        for name, shape, window, make in (
                ("SW", cs.SW, cs.SW_WINDOW, lambda g: {}),
                ("VL-doc", cs.VL_DOC, (-1, -1), lambda g: cs.vl_flags(
                    *(cs.doc_cu_seqlens(g, s, *cs.VL_DOC_LENGTHS),) * 2, s,
                    s))):
            gen = torch.Generator(device="cuda").manual_seed(0)
            b, h, hk, s_, d = cs._dims(shape)
            q, k, v, do = cs._sparse_inputs(gen, shape)
            eff, masks = fwd.build_masks(b, h, s_, s_, True, window,
                                         **make(gen))
            kw = dict(sm_scale=d ** -0.5, causal=eff, softcap=0.0)
            o, lse = fwd.flash_attention_fwd(q, k, v, masks=masks, **kw)
            dst = torch.empty_like(o)
            timed(f"masked fwd {name}", lambda: fwd.launch_flash_fwd(
                q, k, v, dst, None, masks=masks, **kw))
            qs, delta = bwd.flash_bwd_prep(q, o, do, sm_scale=kw["sm_scale"])
            grads = [torch.empty_like(t) for t in (q, k, v)]
            for which, fn in (("dkv", bwd.flash_bwd_dkv),
                              ("dq", bwd.flash_bwd_dq)):
                timed(f"masked {which} {name}", lambda fn=fn: fn(
                    qs, k, v, do, lse, delta, *grads, masks=masks, **kw),
                    iters=10)
            del q, k, v, do, o, lse, qs, delta, grads, masks, dst
            torch.cuda.empty_cache()
    if hasattr(cs, "BIAS_CASES"):
        bias_rows(cs, bwd, fwd, timed)
    if hasattr(cs, "FP8_CASES"):
        fp8_rows(cs, timed)
    print(f"{root}: " + "; ".join(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--bias-only", action="store_true",
                    help="time phase 14's bias rows alone")
    ap.add_argument("--fp8-only", action="store_true",
                    help="time phase 15's fp8 rows alone")
    ap.add_argument("--fp32-only", action="store_true",
                    help="time the fp32 kernels alone")
    ap.add_argument("--dropout-only", action="store_true",
                    help="time the dropout kernels beside their twins")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = ("bias" if args.bias_only else "fp8" if args.fp8_only
            else "fp32" if args.fp32_only
            else "dropout" if args.dropout_only else "")
    if args.child:
        child(Path(args.child), only)
        return
    if len(args.roots) < 2:
        raise SystemExit("give two or more tree roots")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    roots = [str(Path(r).resolve()) for r in args.roots]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                        root] + ([f"--{only}-only"] if only else []),
                       check=True, cwd=root,
                       env={**os.environ, "PYTHONUNBUFFERED": "1"})


if __name__ == "__main__":
    main()
