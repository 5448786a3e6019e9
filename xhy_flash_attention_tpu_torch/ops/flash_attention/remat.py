"""Rematerialisation with the attention's outputs saved (≙ the TPU
package's remat policies, models/gpt.py:228-252, and the names it gives
the attention's residuals, interface.py:109-116).

The model runs each block under ``torch.utils.checkpoint`` (non-reentrant)
with the contexts :func:`checkpoint_contexts` makes. The attention kernels
are ctypes calls inside autograd functions, which selective checkpointing
(it sees dispatcher ops only) cannot cache; so the attention functions
route their forward through :func:`saved_attention`, which under the
forward's context records each call's (out, lse) on a tape of the block,
and under the recompute's context hands them back in order without a
launch. q, k and v are recomputed, as in the TPU package.

Policies:
  * "save_attn": the tape only, so a block keeps its input, one (b, s, h,
    d) output and one (b, h, s) fp32 LSE per attention call, and the
    backward never runs the attention forward kernel;
  * "save_dots": the tape and every matrix product's output (selective
    checkpointing of ``aten.mm`` / ``addmm`` / ``bmm``), as the TPU
    package's dots_saveable with the two names;
  * "nothing": everything recomputed.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Tuple

import torch

__all__ = ["REMAT_POLICIES", "checkpoint_contexts", "saved_attention"]

REMAT_POLICIES = ("save_attn", "save_dots", "nothing")

_state = threading.local()


@contextlib.contextmanager
def _tape_mode(kind: str, tape: List[Tuple[torch.Tensor, ...]]):
    prev = getattr(_state, "mode", None)
    _state.mode = (kind, tape)
    try:
        yield
    finally:
        _state.mode = prev


def saved_attention(fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
                    q: torch.Tensor):
    """``fn()``'s (out, lse) for the query (or packed qkv) tensor ``q``:
    run and recorded under a checkpointed block's forward, taken from the
    tape (no launch) under its recompute, run otherwise. The recompute
    makes the forward's calls again in the same order, so its calls take
    the entries in turn; each entry holds its query's shape, dtype and
    device, and a call whose query differs from its entry's raises
    (``RuntimeError``) rather than take another call's outputs. The one
    relaunch intended is a second backward through the same graph, whose
    recompute finds the tape emptied by the first: ``fn`` runs again."""
    mode = getattr(_state, "mode", None)
    if mode is None:
        return fn()
    kind, tape = mode
    key = (tuple(q.shape), q.dtype, q.device)
    if kind == "replay":
        if not tape:
            return fn()
        got, out, lse = tape.pop(0)
        if got != key:
            raise RuntimeError(
                f"remat: the recomputed attention call's query {key} is not "
                f"the saved call's {got}")
        return out, lse
    out, lse = fn()
    tape.append((key, out.detach(), lse.detach()))
    return out, lse


_DOTS = ("mm", "addmm", "bmm")


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "_overloadpacket", op).__name__
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_contexts(policy: str):
    """The (forward, recompute) contexts of one checkpointed block under
    ``policy`` (``context_fn`` of ``torch.utils.checkpoint``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")
    if policy == "nothing":
        return contextlib.nullcontext(), contextlib.nullcontext()
    tape: List[Tuple[torch.Tensor, ...]] = []
    fwd, rec = _tape_mode("record", tape), _tape_mode("replay", tape)
    if policy == "save_dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        sac_fwd, sac_rec = create_selective_checkpoint_contexts(_save_dots)
        fwd, rec = _both(fwd, sac_fwd), _both(rec, sac_rec)
    return fwd, rec


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def checkpoint_block(block, policy: str, *args):
    """``block(*args)`` under non-reentrant checkpointing with ``policy``."""
    from torch.utils.checkpoint import checkpoint
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=functools.partial(checkpoint_contexts,
                                                   policy))
