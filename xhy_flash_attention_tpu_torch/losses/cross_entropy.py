"""Softmax cross-entropy with label smoothing (≙ xhy_flash_attention_tpu
losses/cross_entropy.py), on one device.

Plain PyTorch, as the JAX package leaves the fusion to XLA: an autograd
function that saves the fp32 LSE, never the softmax, and rebuilds
p = exp(x - lse) in the backward (cross_entropy.py:57-143). Rows are taken
in chunks, so the fp32 copy of the logits that either pass needs is at most
_CHUNK_ELEMS elements at a time. `ignore_index` rows give zero loss and
zero gradient. Both passes run inside a profiler range named
``xfa::cross_entropy``, so a trace can attribute their kernels. The
tensor-parallel vocab split (``axis_name``) comes with slice 9.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy_loss", "CrossEntropyLoss"]

PROFILE_RANGE = "xfa::cross_entropy"
_CHUNK_ELEMS = 1 << 27  # fp32 elements of logits per chunk (512 MiB)
_TP_NOT_PORTED = ("tensor-parallel cross-entropy (axis_name, vocab_start) "
                  "comes with slice 9 (parallelism) (ROADMAP.md, 'Next "
                  "slices of the port')")


def _chunks(n: int, v: int):
    step = max(1, _CHUNK_ELEMS // max(v, 1))
    return [(r, min(n, r + step)) for r in range(0, n, step)]


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, label_smoothing, ignore_index,
                lse_square_scale):
        with torch.profiler.record_function(PROFILE_RANGE):
            return _CrossEntropy._forward(ctx, logits, labels,
                                          label_smoothing, ignore_index,
                                          lse_square_scale)

    @staticmethod
    def _forward(ctx, logits, labels, label_smoothing, ignore_index,
                 lse_square_scale):
        n, v = logits.shape
        safe = labels.clamp(0, v - 1)
        f32 = dict(dtype=torch.float32, device=logits.device)
        lse = torch.empty(n, **f32)
        label_logit = torch.empty(n, **f32)
        sum_logits = torch.zeros(n, **f32)
        for r0, r1 in _chunks(n, v):
            x = logits[r0:r1].float()
            m = x.amax(-1)
            lse[r0:r1] = m + torch.log(torch.exp(x - m[:, None]).sum(-1))
            label_logit[r0:r1] = x.gather(1, safe[r0:r1, None])[:, 0]
            if label_smoothing > 0.0:
                sum_logits[r0:r1] = x.sum(-1)
        eps = label_smoothing
        if eps > 0.0:
            losses = (1.0 - eps) * (lse - label_logit) + eps * (
                lse - sum_logits / v)
        else:
            losses = lse - label_logit
        if lse_square_scale > 0.0:
            losses = losses + lse_square_scale * lse * lse
        valid = labels != ignore_index
        losses = torch.where(valid, losses, 0.0)
        ctx.save_for_backward(logits, safe, lse, valid)
        ctx.args = (label_smoothing, lse_square_scale)
        return losses

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(PROFILE_RANGE):
            return _CrossEntropy._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        logits, safe, lse, valid = ctx.saved_tensors
        eps, sq_scale = ctx.args
        n, v = logits.shape
        grad_scale = torch.where(valid, g, 0.0).float()
        dlogits = torch.empty_like(logits)
        for r0, r1 in _chunks(n, v):
            p = torch.exp(logits[r0:r1].float() - lse[r0:r1, None])
            if sq_scale > 0.0:
                p = p * (1.0 + 2.0 * sq_scale * lse[r0:r1, None])
            rows = torch.arange(r1 - r0, device=p.device)
            p[rows, safe[r0:r1]] -= 1.0 - eps
            if eps > 0.0:
                p -= eps / v
            dlogits[r0:r1] = p * grad_scale[r0:r1, None]
        return dlogits, None, None, None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0, ignore_index: int = -100,
                       lse_square_scale: float = 0.0,
                       axis_name: Optional[str] = None, vocab_start=0):
    """logits: (n, vocab) in any float dtype; labels: (n,) integer ids.

    Returns per-token losses (n,) fp32; differentiable in logits, whose
    gradient comes back in their dtype.
    """
    if axis_name is not None or vocab_start != 0:
        raise NotImplementedError(_TP_NOT_PORTED)
    return _CrossEntropy.apply(logits, labels, float(label_smoothing),
                               int(ignore_index), float(lse_square_scale))


class CrossEntropyLoss:
    """Module-style wrapper (≙ the TPU package's CrossEntropyLoss).
    reduction in {'mean', 'sum', 'none'}; mean divides by the number of
    non-ignored tokens."""

    def __init__(self, ignore_index: int = -100, reduction: str = "mean",
                 label_smoothing: float = 0.0, lse_square_scale: float = 0.0,
                 axis_name: Optional[str] = None):
        if axis_name is not None:
            raise NotImplementedError(_TP_NOT_PORTED)
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.lse_square_scale = lse_square_scale

    def __call__(self, logits, labels, vocab_start: int = 0):
        losses = cross_entropy_loss(
            logits, labels, self.label_smoothing, self.ignore_index,
            self.lse_square_scale, None, vocab_start)
        if self.reduction == "none":
            return losses
        if self.reduction == "sum":
            return losses.sum()
        count = (labels != self.ignore_index).sum()
        return losses.sum() / count.clamp_min(1)
