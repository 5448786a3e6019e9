#!/usr/bin/env python3
"""Which kernels PyTorch's scaled_dot_product_attention runs for fp32 q/k/v
(the yardstick of the fp32 attention rows), forward and backward, at G's
attention (b4 h25 s896 d64 causal), with TF32 off:

    python3 scripts/sdpa_fp32_kernels.py      # on the card, ~20 s

Prints the card's name and power limit, then each device kernel of one
forward and backward under torch.profiler with its device time.
"""

import subprocess

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sdpa_fp32_kernels: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(4, 896, 25, 64, generator=gen, device="cuda")
                   .transpose(1, 2) for _ in range(4))
    ins = [t.detach().requires_grad_() for t in (q, k, v)]

    def step():
        out = F.scaled_dot_product_attention(*ins, is_causal=True)
        torch.autograd.grad(out, ins, do)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            print(f"{e.self_device_time_total / 1e3:9.4f} ms  {e.key[:160]}", flush=True)


if __name__ == "__main__":
    main()
