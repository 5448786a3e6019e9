"""Monitors and metrics of the train loop (≙ xhy_flash_attention_tpu
training/callbacks.py): step time, tokens/s and MFU (analytic FLOPs over
the device's peak), perplexity, a token counter that survives restarts, and
the global gradient norm.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["SpeedMonitor", "gpt_flops_per_token", "Perplexity", "NumTokens",
           "grad_norm", "peak_flops"]

# Dense bf16 tensor-core rate of the cards the port knows (NVIDIA's data
# sheet, SXM part, without sparsity).
_PEAK_BF16 = {"H100": 989e12}


def peak_flops(device) -> Optional[float]:
    """The device's peak bf16 rate: None on the CPU (no MFU there); raises
    for a CUDA card the port does not know."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_BF16.items():
        if key in name:
            return peak
    raise ValueError(f"no peak FLOP/s known for {name!r}: add it to "
                     "training/callbacks.py _PEAK_BF16")


class SpeedMonitor:
    """Rolling tokens/s, step time, and MFU (analytic FLOPs / peak)."""

    def __init__(self, tokens_per_step: int, flops_per_token: float = 0.0,
                 peak_flops: Optional[float] = None, window: int = 20):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.window = window
        self._times = []
        self._last = None

    def step(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            self._times.append(now - self._last)
            self._times = self._times[-self.window:]
            mean_dt = float(np.mean(self._times))
            out["step_ms"] = mean_dt * 1e3
            out["tokens_per_s"] = self.tokens_per_step / mean_dt
            if self.flops_per_token:
                flops_s = self.flops_per_token * out["tokens_per_s"]
                out["tflops_per_s"] = flops_s / 1e12
                if self.peak_flops:
                    out["mfu"] = flops_s / self.peak_flops
        self._last = now
        return out


def gpt_flops_per_token(num_layers: int, hidden: int, seqlen: int,
                        vocab: int, intermediate: Optional[int] = None,
                        causal: bool = True) -> float:
    """Model FLOPs per token, forward and backward (the backward counted as
    twice the forward's matmul FLOPs): attention 4·s·h per token, halved
    when causal."""
    inner = intermediate or 4 * hidden
    qkvo = 2 * 4 * hidden * hidden
    mlp = 2 * 2 * hidden * inner
    attn = 2 * 2 * seqlen * hidden * (0.5 if causal else 1.0)
    head = 2 * hidden * vocab / 1.0
    fwd = num_layers * (qkvo + mlp + attn) + head
    return 3.0 * fwd


@dataclasses.dataclass
class Perplexity:
    """Streaming perplexity over summed token NLL."""

    total_nll: float = 0.0
    total_tokens: int = 0

    def update(self, loss_sum: float, num_tokens: int):
        self.total_nll += float(loss_sum)
        self.total_tokens += int(num_tokens)

    def compute(self) -> float:
        if self.total_tokens == 0:
            return float("inf")
        return float(np.exp(self.total_nll / self.total_tokens))


@dataclasses.dataclass
class NumTokens:
    """Monotonic token counter that survives restarts via state_dict."""

    count: int = 0

    def update(self, n: int):
        self.count += int(n)

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, s):
        self.count = int(s["count"])


def grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm in fp32."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
