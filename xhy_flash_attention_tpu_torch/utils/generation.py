"""Decoding loop and sampling (≙ xhy_flash_attention_tpu utils/generation.py).

A prefill over the prompt, then one model call per generated token against
the dense KV cache. The TPU package compiles the whole loop as one
`lax.while_loop` (generation.py:124-151); the reference FA2 captures its
decode step in a CUDA graph (DecodingCGCache, capture_graph,
flash_attn/utils/generation.py:202-300). Here the step is a
:class:`DecodeStep`: the model over fixed token, offset and cache tensors,
which nothing in it reads on the host, captured once as a CUDA graph
(:class:`CUDAGraphStep`) and replayed per token. Sampling, teacher forcing,
the scores and the eos test stay outside the graph, in a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

__all__ = ["CUDAGraphStep", "DecodeStep", "GenerationMixin", "InferenceParams",
           "decode", "sample_logits"]


@dataclasses.dataclass
class InferenceParams:
    """KV-cache container (≙ the TPU package's InferenceParams and the
    reference's, generation.py:20-32): ``caches`` is a list of per-layer
    (k, v) caches; ``seqlen_offset`` advances after each call."""

    max_seqlen: int
    max_batch_size: int
    caches: Any = None
    seqlen_offset: int = 0


class CUDAGraphStep:
    """``fn()`` run as a CUDA graph: captured at the first call, replayed at
    every later one.

    ``fn`` reads and writes only tensors that outlive it (buffers that the
    caller updates in place between calls) and returns one tensor. With
    ``graph`` the first call runs ``fn`` once on a side stream, so that
    cuBLAS handles, the kernel library and the launch plans are set up
    outside the capture (its effects are the step's, and its output is the
    call's), then captures ``fn`` in the default (global) capture mode.
    Later calls replay the graph and return the captured output tensor,
    which the next replay overwrites. Without ``graph`` each call runs
    ``fn``. An error in the capture or a replay is raised: there is no
    fallback to eager calls.

    ``CUDAGraphStep.captures`` and ``CUDAGraphStep.replays`` count graphs
    captured and replayed, in every instance: a kernel wrapper's launch
    count moves while ``fn`` is captured, once for all replays.
    """

    captures = 0
    replays = 0

    def __init__(self, fn: Callable[[], torch.Tensor], graph: bool):
        self.fn = fn
        self.graph = torch.cuda.CUDAGraph() if graph else None
        self.out: Optional[torch.Tensor] = None

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn()
        if self.out is not None:
            self.graph.replay()
            CUDAGraphStep.replays += 1
            return self.out
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self.fn()
        with torch.cuda.graph(self.graph):  # synchronizes before capture
            out = self.fn()
        # on the side stream, where ``first`` is freed; in inference mode,
        # since ``fn`` may make inference tensors
        with torch.cuda.stream(side), torch.inference_mode():
            out.copy_(first)
        torch.cuda.current_stream().wait_stream(side)
        CUDAGraphStep.captures += 1
        self.out = out
        return out


class DecodeStep:
    """The decode step of one (model, batch, max_length, cache dtype), on
    fixed tensors (≙ the body of the TPU package's while_loop,
    generation.py:128-151, and the reference's DecodingCGCache).

    It owns ``tokens`` (b, 1) int64, ``offset`` (b,) int32 (the cache
    position each row's token is written at) and ``caches``, the model's
    dense caches (bf16 tensors or QuantizedKV, from
    ``model.allocate_kv_caches``). A call runs the model on ``tokens`` at
    ``offset``, writes their keys and values into the caches, advances
    ``offset`` by one and returns the logits (b, vocab). On a CUDA model
    with ``cuda_graph`` the call is a :class:`CUDAGraphStep`, and the
    returned logits are one fixed tensor that the next call overwrites; on
    the CPU, or without ``cuda_graph``, the same step runs uncaptured. The
    caller writes the next tokens (and any other offset) in place.
    """

    def __init__(self, model, batch: int, max_length: int, cache_dtype=None,
                 cuda_graph: bool = True):
        device = model.device
        self.model = model
        self.tokens = torch.zeros(batch, 1, dtype=torch.int64, device=device)
        self.offset = torch.zeros(batch, dtype=torch.int32, device=device)
        self.caches = model.allocate_kv_caches(batch, max_length,
                                               dtype=cache_dtype)
        self._step = CUDAGraphStep(self._forward,
                                   cuda_graph and device.type == "cuda")

    @torch.inference_mode()
    def _forward(self) -> torch.Tensor:
        logits, _ = self.model(self.tokens, kv_caches=list(self.caches),
                               seqlen_offset=self.offset)
        self.offset.add_(1)
        return logits[:, 0]

    def __call__(self) -> torch.Tensor:
        return self._step()


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: int = 1,
                  top_p: float = 0.0):
    """Greedy when top_k == 1 and top_p == 0, else temperature / top-k /
    top-p sampling. logits (b, vocab) -> int64 token ids (b,)."""
    if top_k == 1 and top_p == 0.0:
        return logits.argmax(-1)
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p > 0.0:
        sorted_logits = logits.sort(-1, descending=True).values
        cum = sorted_logits.softmax(-1).cumsum(-1)
        # keep the smallest set with cumulative probability >= top_p
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        cutoff = sorted_logits.gather(1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    probs = logits.softmax(-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def decode(model, input_ids: torch.Tensor, max_length: int, *,
           prompt_lens: Optional[torch.Tensor] = None,
           temperature: float = 1.0, top_k: int = 1, top_p: float = 0.0,
           eos_token_id: Optional[int] = None,
           teacher_outputs: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           return_scores: bool = False, cache_dtype=None,
           cuda_graph: bool = True):
    """Prefill + token-by-token decode on the model's device.

    input_ids: (b, prompt_len), right-padded (prompt_lens for ragged
    prompts: the first token follows each prompt's last valid position).
    Returns (sequences (b, max_length) int64, scores (b, steps, vocab) fp32
    or None). As in the TPU package, every step runs the model, the last
    one included, so the cache holds all max_length positions at the end;
    the loop stops early once every row has emitted eos_token_id.

    The steps run through a :class:`DecodeStep`: on a CUDA model a CUDA
    graph replayed per token (captured at the first step), unless
    ``cuda_graph`` is False (≙ the reference's ``cg`` flag), which runs the
    same step uncaptured. On the CPU it runs uncaptured.
    """
    device = model.device
    input_ids = input_ids.to(device)
    b, prompt_len = input_ids.shape
    num_steps = max(max_length - prompt_len, 0)
    step = DecodeStep(model, b, max_length, cache_dtype, cuda_graph)
    sequences = torch.zeros(b, max_length, dtype=torch.int64, device=device)
    sequences[:, :prompt_len] = input_ids
    if teacher_outputs is not None:
        teacher_outputs = teacher_outputs.to(device)

    logits, _ = model(input_ids, kv_caches=list(step.caches), seqlen_offset=0)
    if prompt_lens is None:
        last = logits[:, -1]
    else:
        idx = (prompt_lens.to(device) - 1).long()
        last = logits[torch.arange(b, device=device), idx]
    scores = (torch.zeros(b, num_steps, logits.shape[-1],
                          dtype=torch.float32, device=device)
              if return_scores else None)
    step.offset.fill_(prompt_len)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    for i in range(num_steps):
        if teacher_outputs is not None:
            tok = teacher_outputs[:, prompt_len + i].long()
        else:
            tok = sample_logits(last, generator, temperature, top_k, top_p)
        if eos_token_id is not None:
            tok = torch.where(finished, eos_token_id, tok)
            finished = finished | (tok == eos_token_id)
        sequences[:, prompt_len + i] = tok
        if scores is not None:
            scores[:, i] = last.float()
        step.tokens.copy_(tok[:, None])
        last = step()
        if eos_token_id is not None and bool(finished.all()):
            break
    return sequences, scores


class GenerationMixin:
    """``generate()`` for a model class (≙ GenerationMixin)."""

    def generate(self, input_ids, max_length, **kw):
        return decode(self, input_ids, max_length, **kw)
