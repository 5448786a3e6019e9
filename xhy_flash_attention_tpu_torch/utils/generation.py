"""Decoding loop and sampling (≙ xhy_flash_attention_tpu utils/generation.py).

A prefill over the prompt, then one model call per generated token against
the dense KV cache. PyTorch runs eagerly, so the loop is a Python loop;
CUDA graphs to cut its launch overhead come in a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["GenerationMixin", "decode", "sample_logits"]


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
           return_scores: bool = False, cache_dtype=None):
    """Prefill + token-by-token decode on the model's device.

    input_ids: (b, prompt_len), right-padded (prompt_lens for ragged
    prompts: the first token follows each prompt's last valid position).
    Returns (sequences (b, max_length) int64, scores (b, steps, vocab) fp32
    or None). As in the TPU package, every step runs the model, the last
    one included, so the cache holds all max_length positions at the end;
    the loop stops early once every row has emitted eos_token_id.
    """
    device = model.device
    input_ids = input_ids.to(device)
    b, prompt_len = input_ids.shape
    num_steps = max_length - prompt_len
    caches = model.allocate_kv_caches(b, max_length, dtype=cache_dtype)
    sequences = torch.zeros(b, max_length, dtype=torch.int64, device=device)
    sequences[:, :prompt_len] = input_ids

    logits, caches = model(input_ids, kv_caches=caches, seqlen_offset=0)
    if prompt_lens is None:
        last = logits[:, -1]
    else:
        idx = (prompt_lens.to(device) - 1).long()
        last = logits[torch.arange(b, device=device), idx]
    scores = (torch.zeros(b, max(num_steps, 0), logits.shape[-1],
                          dtype=torch.float32, device=device)
              if return_scores else None)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    for step in range(max(num_steps, 0)):
        if teacher_outputs is not None:
            tok = teacher_outputs[:, prompt_len + step].to(device).long()
        else:
            tok = sample_logits(last, generator, temperature, top_k, top_p)
        if eos_token_id is not None:
            tok = torch.where(finished, eos_token_id, tok)
            finished = finished | (tok == eos_token_id)
        sequences[:, prompt_len + step] = tok
        if scores is not None:
            scores[:, step] = last.float()
        logits, caches = model(tok[:, None], kv_caches=caches,
                               seqlen_offset=prompt_len + step)
        last = logits[:, 0]
        if eos_token_id is not None and bool(finished.all()):
            break
    return sequences, scores


class GenerationMixin:
    """``generate()`` for a model class (≙ GenerationMixin)."""

    def generate(self, input_ids, max_length, **kw):
        return decode(self, input_ids, max_length, **kw)
