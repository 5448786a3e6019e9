"""Continuous-batching inference engine over paged KV caches (≙
xhy_flash_attention_tpu inference/engine.py).

Design, as in the TPU package:
  * fixed ``max_batch`` slots; each active request owns a slot and a list of
    physical pages (a host-side free-list allocator; the last page is a
    trash page that takes the appends of empty slots);
  * prefill runs the model once per length bucket over the prompts padded
    to the bucket, into a contiguous scratch cache, and the keys and values
    are then scattered into pages (`_scatter_prefill`);
  * prompts longer than ``prefill_chunk`` prefill in chunk-sized pieces, one
    per engine step, interleaved with decode;
  * decode steps run all slots together, one token per slot (or 1 +
    ``speculate_len`` with prompt-lookup speculation) through the model with
    per-layer PagedKVCaches and per-sample lengths; empty slots keep length
    0 and their tokens are discarded.
The page table and lengths live on the host, where the scheduler keeps
them. Before every model call they are copied in place into one page table,
one lengths tensor and one active-slot tensor on the device, which every
layer cache shares, and the token ids into a fixed (max_batch, width)
buffer (on CUDA through pinned buffers, without waiting). The decode step
(width 1) and the speculative verify step (width 1 + speculate_len) read
only those tensors and the caches, and nothing in them is read on the host,
so on CUDA each width runs as a CUDA graph, captured at its first step and
replayed after (≙ the TPU package's `_build_decode` and `_build_verify`,
compiled once per width; `cuda_graph=False` runs the same steps
uncaptured). The bucketed prefill and the chunked-prefill steps run
eagerly.

One difference from the TPU package: there the first chunk of a chunked
prefill is appended to an empty slot (length 0), which the append treats as
inactive, so that chunk's tokens are never attended. Here the chunk step
marks its prefilling slots active (PagedKVCache.active), and chunked
prefill gives the tokens of a whole-prompt prefill.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.quant import QUANT_DTYPES, bits, quantize_kv
from ..utils.generation import CUDAGraphStep
from .paged import PagedKVCache

__all__ = ["InferenceEngine", "Request"]


def _scatter_prefill(caches, new_kv, page_map, slot_ids):
    """Scatter bucketed prefill K/V into their pages, in place.

    new_kv: per layer (k, v) scratch caches (nb, hk, cap, d). page_map: (nb,
    cap // page_size) int64 physical page per (request, block); unused blocks
    point at the trash page. slot_ids: (nb,) int64 batch slot per request
    (the rows of the linear scale buffer).
    """
    idx = page_map.reshape(-1)
    for cache, (kc, vc) in zip(caches, new_kv):
        nb, hk, cap, d = kc.shape
        ps = cache.page_size
        nblk = -(-cap // ps)
        if cap != nblk * ps:  # bucket smaller than a page: pad to one page
            pad = nblk * ps - cap
            kc = torch.nn.functional.pad(kc, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))

        def blocks(x):
            x = bits(x)
            return x.reshape(nb, hk, nblk, ps, d).transpose(1, 2).reshape(
                nb * nblk, hk, ps, d)

        dtype = cache.kv_pages.dtype
        if cache.quantized:
            kq, vq = quantize_kv(kc, dtype), quantize_kv(vc, dtype)
            kvals, vvals = kq.values, vq.values
            # linear per-sequence scales: rows [slot, :, :, :cap], writes past
            # the buffer dropped
            n = min(cap, cache.kv_scales.shape[-1])
            sc = torch.stack([kq.scales[:, :, :n, 0].transpose(1, 2),
                              vq.scales[:, :, :n, 0].transpose(1, 2)],
                             dim=-1)                          # (nb, n, hk, 2)
            posc = torch.arange(n, device=kc.device)
            cache.kv_scales[slot_ids[:, None], :, :, posc[None, :]] = sc
        else:
            kvals, vvals = kc.to(dtype), vc.to(dtype)
        bits(cache.kv_pages)[idx] = torch.stack(
            [blocks(kvals), blocks(vvals)], dim=2)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 => greedy
    eos_token_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0                # prompt tokens already in cache


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


class InferenceEngine:
    """Serve requests with continuous batching.

    model: a callable ``model(input_ids, kv_caches=..., seqlen_offset=...)
    -> (logits, kv_caches)``, as GPTLMHeadModel is (a PyTorch module carries
    its weights, so there is no separate params argument). Its attention
    must be causal: the bucketed prefill pads prompts on the right.
    rng: the numpy generator that temperature sampling draws from
    (default_rng(0) when None).

    ``stats`` counts the model calls by kind: "prefill" (one per length
    bucket of admitted prompts, with "prefill_tokens" the prompts' tokens),
    "chunk" (chunked-prefill steps), "decode" and "verify" (speculative
    steps).

    cuda_graph: run the decode and verify steps as CUDA graphs on a CUDA
    device (the default); False runs them uncaptured. Ignored on the CPU.
    """

    def __init__(
        self,
        model: Callable,
        *,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        num_pages: int = 256,
        page_size: int = 512,
        max_batch: int = 8,
        max_pages_per_seq: int = 32,
        dtype=torch.bfloat16,
        prefill_chunk: Optional[int] = None,
        speculate_len: int = 0,
        speculate_ngram: int = 2,
        device=None,
        rng: Optional[np.random.Generator] = None,
        cuda_graph: bool = True,
    ):
        if any(not m.causal for m in getattr(model, "modules", list)()
               if hasattr(m, "causal")):
            raise ValueError("the engine's bucketed prefill pads prompts on "
                             "the right and needs causal attention")
        self.model = model
        self.device = torch.device(device if device is not None
                                   else getattr(model, "device", "cuda"))
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = prefill_chunk
        self._prefilling: List[Request] = []
        self.speculate_len = speculate_len
        self.speculate_ngram = speculate_ngram
        self.trash_page = num_pages - 1  # sink for inactive-slot appends
        dev = self.device
        # the device tensors that the model calls read, updated in place
        self._dev: Dict[Any, torch.Tensor] = {
            "table": torch.full((max_batch, max_pages_per_seq),
                                self.trash_page, dtype=torch.int32,
                                device=dev),
            "lengths": torch.zeros(max_batch, dtype=torch.int32, device=dev),
            "active": torch.zeros(max_batch, dtype=torch.bool, device=dev)}
        self.caches = [
            dataclasses.replace(
                PagedKVCache.create(num_pages, num_kv_heads, page_size,
                                    head_dim, max_batch, max_pages_per_seq,
                                    dtype, device=dev),
                page_table=self._dev["table"], lengths=self._dev["lengths"],
                active=self._dev["active"])
            for _ in range(num_layers)]
        self.cuda_graph = cuda_graph and dev.type == "cuda"
        self._steps: Dict[int, CUDAGraphStep] = {}
        self._pinned: Dict[Any, torch.Tensor] = {}
        # recorded after the copies out of the pinned buffers
        self._pushed = torch.cuda.Event() if dev.type == "cuda" else None
        self._table = np.full((max_batch, max_pages_per_seq), self.trash_page,
                              np.int32)
        self._lengths = np.zeros((max_batch,), np.int32)
        self.free_pages = list(range(num_pages - 2, -1, -1))
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._last_tokens = np.zeros((max_batch,), np.int64)
        self._rng = rng if rng is not None else np.random.default_rng(0)
        self.stats = collections.Counter()

    # ---- paging -----------------------------------------------------------

    def _capacity(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def _cover(self, req: Request, n_tokens: int, what: str):
        """Allocate pages until ``req`` covers positions [0, n_tokens).
        Raises ValueError past the page table: append_paged_kv would clamp
        such rows onto the sequence's last page, over committed ones."""
        if n_tokens > self._capacity():
            raise ValueError(
                f"request {req.rid}: {what} writes {n_tokens} positions, "
                f"more than max_pages_per_seq * page_size = "
                f"{self._capacity()}")
        while len(req.pages) < -(-n_tokens // self.page_size):
            self._alloc_page(req)

    def _alloc_page(self, req: Request) -> int:
        if not self.free_pages:
            raise RuntimeError("out of KV pages")
        p = self.free_pages.pop()
        req.pages.append(p)
        self._table[req.slot, len(req.pages) - 1] = p
        return p

    def _release(self, req: Request):
        self.free_pages.extend(req.pages)
        req.pages.clear()
        self._table[req.slot] = self.trash_page
        self._lengths[req.slot] = 0
        self.slots[req.slot] = None
        req.slot = -1

    def _push(self, arrays: Dict[Any, np.ndarray]):
        """Copy host arrays into the device tensors of the same keys, in
        place. On CUDA through pinned buffers by non-blocking copies: the
        host waits only before it refills a pinned buffer that the last
        push's copies may still be reading."""
        if self._pushed is not None:
            self._pushed.synchronize()
        for key, src in arrays.items():
            dst, src = self._dev[key], torch.from_numpy(src)
            if self._pushed is None:
                dst.copy_(src)
                continue
            if key not in self._pinned:
                self._pinned[key] = torch.empty(dst.shape, dtype=dst.dtype,
                                                pin_memory=True)
            self._pinned[key].copy_(src)
            dst.copy_(self._pinned[key], non_blocking=True)
        if self._pushed is not None:
            self._pushed.record()

    def _sync_caches(self, active: Optional[np.ndarray] = None,
                     ids: Optional[np.ndarray] = None):
        """Push the host page table, lengths and active slots (default: the
        slots holding tokens, lengths > 0) into the tensors that every layer
        cache shares, and ``ids`` (max_batch, width), when given, into the
        token buffer of its width."""
        arrays = {"table": self._table, "lengths": self._lengths,
                  "active": self._lengths > 0 if active is None else active}
        if ids is not None:
            key = ("ids", ids.shape[1])
            if key not in self._dev:
                self._dev[key] = torch.zeros(ids.shape, dtype=torch.int64,
                                             device=self.device)
            arrays[key] = ids
        self._push(arrays)

    @torch.inference_mode()
    def _forward(self, width: int) -> torch.Tensor:
        """The model over the token buffer of ``width`` at the slots'
        lengths; the pages are written in place, the caches stay as they
        are (the host advances the lengths)."""
        logits, _ = self.model(self._dev[("ids", width)],
                               kv_caches=list(self.caches),
                               seqlen_offset=self._dev["lengths"])
        return logits

    def _step(self, width: int) -> CUDAGraphStep:
        """The step of ``width`` (decode 1, verify 1 + speculate_len): a
        CUDA graph on CUDA, captured at its first call."""
        if width not in self._steps:
            self._steps[width] = CUDAGraphStep(
                functools.partial(self._forward, width), self.cuda_graph)
        return self._steps[width]

    def _run(self, ids: np.ndarray) -> torch.Tensor:
        """A decode or verify step over the paged caches: ``ids``
        (max_batch, width) at the slots' lengths. Returns the step's fixed
        logits, which its next call overwrites."""
        self._sync_caches(ids=ids)
        return self._step(ids.shape[1])()

    # ---- scheduling -------------------------------------------------------

    def add_request(self, req: Request):
        """Queue ``req``. Raises ValueError when its prompt, new tokens and
        speculated drafts would run past the page table
        (``max_pages_per_seq * page_size`` positions)."""
        need = len(req.prompt) + req.max_new_tokens + self.speculate_len
        if need > self._capacity():
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens}"
                + (f" + speculate_len {self.speculate_len}"
                   if self.speculate_len else "")
                + f" = {need} positions, more than max_pages_per_seq * "
                f"page_size = {self._capacity()}")
        self.waiting.append(req)

    def _admit(self):
        admitted = []
        for i in range(self.max_batch):
            if not self.waiting:
                break
            if self.slots[i] is None:
                req = self.waiting.pop(0)
                req.slot = i
                self.slots[i] = req
                admitted.append(req)
        # long prompts go through chunked prefill (one chunk per engine
        # step, interleaved with decode); short ones take the one-shot
        # bucketed prefill below
        direct = []
        for r in admitted:
            if (self.prefill_chunk is not None
                    and len(r.prompt) > self.prefill_chunk):
                self._lengths[r.slot] = 0
                self._prefilling.append(r)
            else:
                direct.append(r)
        # one forward per length bucket
        by_bucket: Dict[int, List[Request]] = {}
        for r in direct:
            by_bucket.setdefault(_bucket(len(r.prompt)), []).append(r)
        for cap, reqs in by_bucket.items():
            self._prefill_batch(reqs, cap)

    def _prefill_chunk_step(self):
        """Advance every in-prefill request by one ``prefill_chunk``-token
        piece in one batched model call through the paged path (multi-token
        append + paged decode with sq > 1). Other slots append garbage past
        their committed length, which the next real append overwrites."""
        if not self._prefilling:
            return
        chunk = self.prefill_chunk
        ids = np.zeros((self.max_batch, chunk), np.int32)
        active = self._lengths > 0
        for r in self._prefilling:
            active[r.slot] = True
        # every active slot takes all `chunk` rows (past a slot's committed
        # length they are garbage that later appends overwrite): they must
        # stay inside the page table
        for slot in np.flatnonzero(active):
            if self._lengths[slot] + chunk > self._capacity():
                raise ValueError(
                    f"request {self.slots[slot].rid}: a prefill chunk of "
                    f"{chunk} at length {self._lengths[slot]} runs past "
                    f"max_pages_per_seq * page_size = {self._capacity()}")
        for r in self._prefilling:
            n = min(chunk, len(r.prompt) - r.prefill_pos)
            ids[r.slot, :n] = np.asarray(
                r.prompt[r.prefill_pos:r.prefill_pos + n], np.int32)
            self._cover(r, r.prefill_pos + n, "a prefill chunk")
        self._sync_caches(active, ids)
        logits = self._forward(chunk)  # eager: one shape, device-bound
        self.stats["chunk"] += 1
        still = []
        for r in self._prefilling:
            n = min(chunk, len(r.prompt) - r.prefill_pos)
            r.prefill_pos += n
            self._lengths[r.slot] = r.prefill_pos
            if r.prefill_pos >= len(r.prompt):
                tok = self._sample(logits[r.slot, n - 1], r)
                r.output.append(tok)
                self._last_tokens[r.slot] = tok
            else:
                still.append(r)
        self._prefilling = still

    # ---- prefill ----------------------------------------------------------

    def _prefill_batch(self, reqs, cap: int):
        nb = len(reqs)
        ids = np.zeros((nb, cap), np.int32)
        lens = [len(r.prompt) for r in reqs]
        for j, r in enumerate(reqs):
            ids[j, :lens[j]] = np.asarray(r.prompt, np.int32)
        # contiguous scratch cache for the prompts, scattered into pages
        # after (it stays float: quantization happens at page-write time)
        hk, d = self.caches[0].kv_pages.shape[1], self.caches[0].kv_pages.shape[4]
        dt = self.caches[0].kv_pages.dtype
        if dt in QUANT_DTYPES:
            dt = torch.bfloat16
        scratch = [
            (torch.zeros(nb, hk, cap, d, dtype=dt, device=self.device),
             torch.zeros(nb, hk, cap, d, dtype=dt, device=self.device))
            for _ in self.caches
        ]
        # The TPU package passes segment ids (1 on the prompt, 0 on the pad).
        # With prompts padded on the right and causal attention, a prompt
        # token never sees a pad key, so dropping them changes no prompt
        # output, and no pad position is ever read back (the lengths stop
        # before it).
        with torch.inference_mode():
            logits, new_caches = self.model(
                torch.from_numpy(ids).to(self.device, torch.int64),
                kv_caches=scratch, seqlen_offset=0)
        self.stats["prefill"] += 1
        self.stats["prefill_tokens"] += sum(lens)
        nblk = -(-cap // self.page_size)
        page_map = np.full((nb, nblk), self.trash_page, np.int64)
        for j, req in enumerate(reqs):
            n = lens[j]
            nblocks = -(-n // self.page_size)
            while len(req.pages) < nblocks:
                self._alloc_page(req)
            page_map[j, :nblocks] = req.pages[:nblocks]
            self._lengths[req.slot] = n
        _scatter_prefill(
            self.caches, new_caches, torch.from_numpy(page_map).to(self.device),
            torch.tensor([r.slot for r in reqs], device=self.device))
        for j, req in enumerate(reqs):
            tok = self._sample(logits[j, lens[j] - 1], req)
            req.output.append(tok)
            self._last_tokens[req.slot] = tok

    # ---- decode -----------------------------------------------------------

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        """One token from a (vocab,) row of logits: argmax on the device for
        greedy requests, else the row on the host for numpy sampling."""
        if req.temperature <= 0.0:
            return int(logits.argmax())
        row = logits.float().cpu().numpy().astype(np.float64)
        p = np.exp((row - row.max()) / req.temperature)
        p = p / p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _decode_step(self, active: List[Request]):
        for r in active:  # a page for the next token of each active slot
            self._cover(r, len(r.prompt) + len(r.output), "a decode step")
        logits = self._run(self._last_tokens[:, None])[:, 0]
        self.stats["decode"] += 1
        greedy = logits.argmax(-1).cpu().numpy()
        for r in active:
            # mirror the in-model append's length increment
            self._lengths[r.slot] += 1
        for r in active:
            tok = (int(greedy[r.slot]) if r.temperature <= 0.0
                   else self._sample(logits[r.slot], r))
            self._finish_tokens(r, [tok])

    # ---- speculative decode (prompt lookup) -------------------------------

    def _propose(self, r: Request) -> List[int]:
        """Draft up to speculate_len tokens: find the most recent earlier
        occurrence of the trailing n-gram in the request's own history
        (prompt + generated) and copy what followed it. Empty when no
        match."""
        n, K = self.speculate_ngram, self.speculate_len
        hist = list(r.prompt) + r.output
        if len(hist) <= n:
            return []
        tail = hist[-n:]
        for i in range(len(hist) - n - 1, -1, -1):
            if hist[i:i + n] == tail:
                cont = hist[i + n:i + n + K]
                if cont:
                    return [int(t) for t in cont]
        return []

    def _finish_tokens(self, r: Request, toks: List[int]):
        """Append emitted tokens, honoring eos and max_new_tokens; returns
        the count kept (tokens after a cut are dropped)."""
        kept = 0
        for tok in toks:
            r.output.append(tok)
            self._last_tokens[r.slot] = tok
            kept += 1
            if (len(r.output) >= r.max_new_tokens
                    or (r.eos_token_id is not None
                        and tok == r.eos_token_id)):
                self._release(r)
                self.finished.append(r)
                return kept
        return kept

    def _decode_speculative(self, active: List[Request]):
        K = self.speculate_len
        width = 1 + K
        ids = np.zeros((self.max_batch, width), np.int32)
        drafts: Dict[int, List[int]] = {}
        for r in active:
            d = self._propose(r) if r.temperature <= 0.0 else []
            drafts[r.slot] = d
            ids[r.slot, 0] = self._last_tokens[r.slot]
            ids[r.slot, 1:1 + len(d)] = d
            # pages must cover the whole appended width
            self._cover(r, int(self._lengths[r.slot]) + width,
                        "a speculative step")
        logits = self._run(ids)
        self.stats["verify"] += 1
        greedy = logits.argmax(-1).cpu().numpy()
        for r in active:
            d = drafts[r.slot]
            emitted = []
            m = 0  # matched drafts (their KV is already committed)
            for i in range(len(d) + 1):
                tok = (int(greedy[r.slot, i]) if r.temperature <= 0.0
                       else self._sample(logits[r.slot, i], r))
                emitted.append(tok)
                if i < len(d) and tok == d[i]:
                    m += 1
                else:
                    break
            self._finish_tokens(r, emitted)
            if r.slot >= 0:  # not released by eos / max_new_tokens
                # committed cache tokens: last token + matched drafts (the
                # final emitted token stays pending, like normal decode)
                self._lengths[r.slot] += 1 + m

    def step(self) -> List[Request]:
        """Admit waiting requests, advance chunked prefills by one chunk,
        run one decode step (speculative when enabled); return the requests
        that finished."""
        self._admit()
        self._prefill_chunk_step()
        prefilling = set(id(r) for r in self._prefilling)
        active = [r for r in self.slots
                  if r is not None and id(r) not in prefilling]
        if active:
            if self.speculate_len > 0:
                self._decode_speculative(active)
            else:
                self._decode_step(active)
        done, self.finished = self.finished, []
        return done

    def run(self) -> Dict[int, List[int]]:
        """Drive until every queued request completes."""
        results: Dict[int, List[int]] = {}
        while self.waiting or any(s is not None for s in self.slots):
            for r in self.step():
                results[r.rid] = r.output
        return results
