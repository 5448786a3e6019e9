#!/usr/bin/env python3
"""A/B timing of the attention forward's and the reduced scores' design
choices on one card.

    python3 scripts/ab_flash_fwd.py                    # every variant
    python3 scripts/ab_flash_fwd.py base unsectioned  # some of them

Each variant is the kernel sources of ``xhy_flash_attention_tpu_torch/csrc``
with a few text edits (``VARIANTS``), copied into
``xhy_flash_attention_tpu_torch/build/ab_fwd/<name>`` (ignored by git),
built there and timed in a child process of its own, with CUDA events
after a warm-up: the masked forward (the kernel alone, the mask's
arguments made once) under chip_smoke.py's FM-doc, BS and FM-swg masks
(the same seeded data for every variant), the dense forward at request A's
shape (b2 h32 hk8 s2048 d128 causal) and at T-long's (b16 h16 s2048 d64
causal), and the reduced scores at FM-swg's shape. Each variant's masked
forward at FM-doc is held against its plain version (largest error over
the largest output, printed). The variants run in turns, first to last and
then last to first, so that each is timed twice on the same card. Prints
the card's name and power limit first.
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
AB_ROOT = ROOT / "xhy_flash_attention_tpu_torch" / "build" / "ab_fwd"

# name -> [(file, old text, new text)]: each old text must occur in the file
VARIANTS = {
    "base": [],
    # the masked kernels' scheduler in sections of 32 (batch, head) rows (16
    # MB of K/V at T-long's shape), heaviest pair of every row of a section
    # first, so that the blocks at work at one time share L2
    "sectioned": [
        ("common.cuh", """    const int j = (item >> 1) / n_bh;
    if (j >= per_head) return false;
    const int pair = ((item >> 1) - j * n_bh) * per_head + j;""",
         """    const int section = 32, idx = item >> 1, sec = idx / (section * per_head);
    const int n_sec = min(section, n_bh - sec * section);
    const int within = idx - sec * section * per_head;
    const int j = n_sec > 0 ? within / n_sec : per_head;
    if (j >= per_head) return false;
    const int pair = (sec * section + within - j * n_sec) * per_head + j;""")],
    # the masked forward at d 64 issues tile i's QK^T with tile i - 1's P.V
    # and runs tile i's softmax under it, as the dense route does
    "masked_pipelined": [
        ("flash_fwd.cu", """        // one tile after the other at both head dims (at d 64, tile i's
        // softmax under tile i - 1's P.V, as the dense route runs it, took
        // 3-6% longer here: scripts/ab_flash_fwd.py masked_pipelined)
        while (next_tile()) {
          const int st = stage(it);
          sm90::wgmma_fence();
          issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(s);
          softmax_tile();
          pack_p(s, pa);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
          sm90::mbar_wait(bar_v + 8 * st, parity(it));
          sm90::fence_regs(o);
          sm90::fence_regs(pa);
          sm90::wgmma_fence();
          issue_pv<D>(o, pa, base + S::kV + st * S::kStage);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);
          ++it;
        }

""",
         """        if constexpr (D == 64) {
          // as in the dense route: QK^T(i) under PV(i - 1)
          if (next_tile()) {
            sm90::wgmma_fence();
            issue_qk<D>(s, q_wg, base + S::kK + stage(it) * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s);
            softmax_tile();
            pack_p(s, pa);
            int prev = it++;
            while (next_tile()) {
              const int st = stage(it), pv = stage(prev);
              sm90::mbar_wait(bar_v + 8 * pv, parity(prev));
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              sm90::wgmma_fence();
              issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
              issue_pv<D>(o, pa, base + S::kV + pv * S::kStage);
              sm90::wgmma_wait<1>();
              sm90::fence_regs(s);
              softmax_tile();
              sm90::wgmma_wait<0>();
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              if (lane == 0) sm90::mbar_arrive(bar_e + 8 * pv);
#pragma unroll
              for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
              pack_p(s, pa);
              prev = it++;
            }
            const int pv = stage(prev);
            sm90::mbar_wait(bar_v + 8 * pv, parity(prev));
            sm90::fence_regs(o);
            sm90::fence_regs(pa);
            sm90::wgmma_fence();
            issue_pv<D>(o, pa, base + S::kV + pv * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(o);
            if (lane == 0) sm90::mbar_arrive(bar_e + 8 * pv);
          }
        } else {
          while (next_tile()) {
            const int st = stage(it);
            sm90::wgmma_fence();
            issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s);
            softmax_tile();
            pack_p(s, pa);
#pragma unroll
            for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
            sm90::mbar_wait(bar_v + 8 * st, parity(it));
            sm90::fence_regs(o);
            sm90::fence_regs(pa);
            sm90::wgmma_fence();
            issue_pv<D>(o, pa, base + S::kV + st * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(o);
            if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);
            ++it;
          }
        }

""")],
    # Timing probes (results wrong by design except where noted): the
    # masked epilogue releases its Q buffer without waiting for the O
    # store to read it (right in practice: the buffer is loaded again a
    # block later); every masked tile takes the one elementwise test
    # without bands (right for BS only)
    "probe_store_nowait": [
        ("flash_fwd.cu", "            sm90::tma_store_commit();\n            sm90::tma_store_wait_read();",
         "            sm90::tma_store_commit();")],
    # the tile word and the block slot read by every lane (not broadcast
    # from lane 0, so not known warp-uniform to the compiler)
    "per_lane_words": [
        ("flash_fwd.cu", "        const int m_block = __shfl_sync(0xffffffffu, blk.x, 0);",
         "        const int m_block = blk.x;"),
        ("flash_fwd.cu", "            w.x = __shfl_sync(0xffffffffu, w.x, 0);\n"
         "            w.y = __shfl_sync(0xffffffffu, w.y, 0);\n", "")],
    # the producer reads each block-mask entry behind the part's range test
    # (a short-circuit `&&`: the four loads one after the other)
    "bm_per_part": [
        ("common.cuh", """    const int* bm = m.bm + batch * m.bm_sb + (head / (h / m.bm_heads)) * m.bm_sh;
    int e[4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int row = min(q0 + 64 * c, sq - 1), key = min(n0 + (N == 128 ? 64 * kh : 0), sk - 1);
        e[2 * c + kh] = bm[static_cast<int64_t>(row / m.gq) * m.bm_nk + key / m.gk];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) on &= ~((e[i] == 0 ? 1 : 0) << i);""",
         """#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int row = q0 + 64 * c, key = n0 + (N == 128 ? 64 * kh : 0);
        if ((on >> (2 * c + kh)) & 1 && !bm_on(m, batch, head, h, row, key))
          on &= ~(1 << (2 * c + kh));
      }""")],
    # the masked producer takes and decides the next block only after the
    # current block's last tile (not ahead, while the ring is full)
    "decide_inline": [
        ("flash_fwd.cu", "              if (ahead) return;", "              return;")],
    # one band variant for every FlashMask mode (a causal mode's second
    # band is empty)
    "nb2": [
        ("flash_fwd.cu", "          } else if (p.mask.fm_mode <= xfa::kFmCausal2) {\n"
         "            masked_softmax<true, 1>(s, m_i, l_i, alpha, w.x, row0, parts, bands, p, t);\n"
         "          } else {",
         "          } else {")],
    # probe: the producer takes every block-mask entry as on (right for a
    # mask of ones only)
    "probe_no_bm": [
        ("common.cuh", "  if (m.bm != nullptr && on != 0) {", "  if (false) {")],
    "probe_one_softmax": [
        ("flash_fwd.cu", "          if (!(w.y & kElem)) {\n            masked_softmax<false, 0>",
         "          if (true) {\n            masked_softmax<true, 0>")],
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
            raise SystemExit(f"variant {name}: text not found in {fname}")
        path.write_text(text.replace(old, new))
    return dst


def child(csrc: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    from xhy_flash_attention_tpu_torch.ops import _cuda
    _cuda.CSRC = csrc
    _cuda.BUILD_ROOT = csrc.parent / (csrc.name + "_build")
    import chip_smoke as cs
    from xhy_flash_attention_tpu_torch import global_sliding_window_mask
    from xhy_flash_attention_tpu_torch.ops.flash_attention import (
        common, fwd, reduced_scores as rs)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    out = []
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
        q, k, v, _ = cs._sparse_inputs(gen, shape)
        flags = make(gen, b, s)
        masks = common.KernelMasks(b, h, s, s, **flags)
        masks.bands()
        kw = dict(sm_scale=d ** -0.5, causal=causal, softcap=0.0)
        o = torch.empty(b, s, h, d, dtype=q.dtype, device="cuda").transpose(1, 2)
        ms = cs.time_ms([lambda: fwd.launch_flash_fwd(q, k, v, o, None,
                                                      masks=masks, **kw)])
        note = ""
        if name == "FM-doc":
            ref, _ = cs.plain_fwd_groups(
                q, k, v, common.dense_keep_mask(s, s, h, **flags), **kw)
            note = (f" (err {cs.max_err(o, ref) / ref.float().abs().max().item():.3g}"
                    " of max|out|)")
            del ref
        out.append(f"masked fwd {name} {ms:.4f}{note}")
        if name == "FM-swg":
            _, lse = fwd.flash_attention_fwd(q, k, v, **kw, **flags)
            ms = cs.time_ms([lambda: rs.calc_reduced_attn_scores(
                q, k, lse, causal=True)])
            out.append(f"reduced {name} {ms:.4f}")
        del q, k, v, o, masks
        torch.cuda.empty_cache()
    for name, (b, h, hk, s, d) in (("A", (2, 32, 8, 2048, 128)),
                                   ("T-long", (16, 16, 16, 2048, 64))):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, _ = cs._sparse_inputs(gen, dict(b=b, h=h, hk=hk, s=s, d=d))
        o = torch.empty_like(q)
        ms = cs.time_ms([lambda: fwd.launch_flash_fwd(
            q, k, v, o, None, sm_scale=d ** -0.5, causal=True, softcap=0.0)])
        out.append(f"dense fwd {name} {ms:.4f}")
        if name == "T-long":
            # the same non-causal work, dense and through the masked
            # instantiation under a block mask of ones: the masked route's
            # own cost
            ones = common.KernelMasks(b, h, s, s, block_mask=(torch.ones(
                1, 1, s // 256, s // 256, dtype=torch.int32, device="cuda"),
                256, 256))
            for what, m in (("dense full", None), ("masked ones", ones)):
                ms = cs.time_ms([lambda m=m: fwd.launch_flash_fwd(
                    q, k, v, o, None, sm_scale=d ** -0.5, causal=False,
                    softcap=0.0, masks=m)])
                out.append(f"{what} {name} {ms:.4f}")
    print(f"{label}: " + "; ".join(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--child", nargs=2, metavar=("CSRC", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child[0]), args.child[1])
        return
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    import subprocess as sp
    print(sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"], capture_output=True,
                 text=True).stdout.strip(), flush=True)
    dirs = {v: make_variant(v) for v in args.variants}
    order = list(args.variants) + list(reversed(args.variants))
    for i, v in enumerate(order):
        subprocess.run([sys.executable, __file__, "--child", str(dirs[v]),
                        f"{v} (turn {i + 1})"], check=True,
                       env={**os.environ, "PYTHONUNBUFFERED": "1"})


if __name__ == "__main__":
    main()
