"""Optimizer: parameter grouping and learning-rate schedules (≙
xhy_flash_attention_tpu training/optim.py).

`make_optimizer` is the optax chain of the JAX package,
``clip_by_global_norm(grad_clip) -> adamw(lr_schedule, mask=decay_mask)``
(optim.py:59-76), written out with optax's formulas on dictionaries of fp32
tensors that it updates in place:

* clipping: when the global norm g of the gradients is not below
  ``grad_clip``, every gradient becomes (grad / g) * grad_clip (not
  ``torch.nn.utils.clip_grad_norm_``'s grad * grad_clip / (g + 1e-6));
* Adam: mu = b1 mu + (1 - b1) grad, nu = b2 nu + (1 - b2) grad^2, with the
  bias corrections 1 - b^t of step t = 1, 2, ...; the update
  mu_hat / (sqrt(nu_hat) + eps), plus weight_decay * param where the mask
  allows, times -lr(count);
* the schedule counts from 0, as optax does: the first step of a warmup
  has learning rate 0.

The moments are fp32, like the parameters they update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import torch

from .callbacks import grad_norm
from .config import OptimizerConfig, SchedulerConfig

__all__ = ["Optimizer", "decay_mask", "make_optimizer", "make_schedule"]


def decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: 2-D and larger weights (linear and
    embedding weights); biases and norm weights are excluded (the JAX
    package's rule on flax names, optim.py:22-40, applied to this port's
    names)."""
    out = {}
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias" or (leaf in ("weight", "scale") and p.dim() <= 1):
            out[name] = False
        else:
            out[name] = p.dim() >= 2
    return out


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    def schedule(count: int) -> float:
        count = min(count, steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def make_schedule(cfg: SchedulerConfig) -> Callable[[int], float]:
    """The learning-rate multiplier of update ``count`` (0, 1, ...)."""
    if cfg.name == "constant":
        return lambda count: 1.0
    warmup = _linear(0.0, 1.0, max(cfg.warmup_steps, 1))
    rest_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.name == "cosine_warmup":
        rest = _cosine(1.0, rest_steps, cfg.min_lr_ratio)
    elif cfg.name == "linear_warmup":
        rest = _linear(1.0, cfg.min_lr_ratio, rest_steps)
    else:
        raise ValueError(cfg.name)
    boundary = cfg.warmup_steps

    def schedule(count: int) -> float:  # optax.join_schedules
        return warmup(count) if count < boundary else rest(count - boundary)
    return schedule


class Optimizer:
    """clip_by_global_norm -> adamw over dictionaries name -> fp32 tensor.
    ``init`` returns the state; ``update`` changes the parameters and the
    state in place and returns the global gradient norm before clipping."""

    def __init__(self, opt_cfg: OptimizerConfig, sched_cfg: SchedulerConfig):
        if opt_cfg.name != "adamw":
            raise ValueError(f"optimizer {opt_cfg.name!r}: the recipes use "
                             "adamw, the one the port has")
        self.cfg = opt_cfg
        self.schedule = make_schedule(sched_cfg)

    def lr(self, count: int) -> float:
        return self.cfg.lr * self.schedule(count)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = list(params)
        gs = [grads[n] for n in names]
        gnorm = grad_norm(gs)
        clip = self.cfg.grad_clip
        if clip > 0:
            g_norm = float(gnorm)
            if not g_norm < clip:
                gs = [g / g_norm * clip for g in gs]
        lr = self.lr(state["count"])
        ps = [params[n] for n in names]
        b1, b2 = self.cfg.betas
        mus = [state["mu"][n] for n in names]
        nus = [state["nu"][n] for n in names]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, gs, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mus, 1 - b1 ** count)
        den = torch._foreach_div(nus, 1 - b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.cfg.eps)
        upd = torch._foreach_div(mu_hat, den)
        del mu_hat, den
        wd = self.cfg.weight_decay
        if wd > 0:
            mask = decay_mask(params)
            dec = [i for i, n in enumerate(names) if mask[n]]
            torch._foreach_add_([upd[i] for i in dec], [ps[i] for i in dec],
                                alpha=wd)
        torch._foreach_add_(ps, upd, alpha=-lr)
        state["count"] = count
        return gnorm


def make_optimizer(opt_cfg: OptimizerConfig,
                   sched_cfg: SchedulerConfig) -> Optimizer:
    return Optimizer(opt_cfg, sched_cfg)
