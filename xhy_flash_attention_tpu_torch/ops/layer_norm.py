"""Fused residual add + LayerNorm / RMSNorm, forward (≙
xhy_flash_attention_tpu ops/layer_norm.py).

    residual_out = x0 + residual          (fp32 if residual_in_fp32)
    out          = norm(residual_out) * weight + bias

prenorm returns (out, residual_out). On a CUDA tensor the work runs in the
kernel csrc/rms_norm_add.cu (the counterpart of the TPU kernel
`_ln_fwd_kernel`, layer_norm.py:48); on a CPU tensor in its plain version
:func:`ln_fwd_ref`. Dropout, rowscale and layerscale, and the backward, wait
for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

__all__ = [
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "layer_norm",
    "ln_fwd",
    "ln_fwd_ref",
    "rms_norm",
]

_NOT_PORTED = ("dropout, rowscale and layerscale in the fused norm come with "
               "slice 3 (Training), beside TPU kernel #8 (ROADMAP.md, 'Next "
               "slices of the port')")


def ln_fwd_ref(x0, residual, weight, bias, eps: float, is_rms: bool,
               res_dtype: torch.dtype, save_resout: bool):
    """Plain version of the kernel on (rows, hidden) inputs: the same
    fp32 arithmetic, in the same order. Returns (out, residual_out | None)."""
    x = x0.float()
    if residual is not None:
        x = x + residual.float()
    if is_rms:
        xc = x
        var = (x * x).mean(-1, keepdim=True)
    else:
        xc = x - x.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x0.dtype), (x.to(res_dtype) if save_resout else None)


def ln_fwd(x0, residual, weight, bias, eps: float, is_rms: bool,
           res_dtype: torch.dtype, save_resout: bool):
    """Kernel wrapper on (rows, hidden) inputs; see :func:`ln_fwd_ref`.

    ``ln_fwd.launches`` counts kernel launches.
    """
    if x0.device.type == "cpu":
        return ln_fwd_ref(x0, residual, weight, bias, eps, is_rms, res_dtype,
                          save_resout)
    tensors = [t for t in (x0, residual, weight, bias) if t is not None]
    _cuda.require_cuda(*tensors)
    if x0.dim() != 2 or weight.shape != (x0.shape[1],):
        raise ValueError(f"x0 {tuple(x0.shape)} and weight "
                         f"{tuple(weight.shape)} do not match")
    if residual is not None and residual.shape != x0.shape:
        raise ValueError("residual must have x0's shape")
    x0 = x0.contiguous()
    residual = residual.contiguous() if residual is not None else None
    weight = weight.float().contiguous()
    bias = bias.float().contiguous() if bias is not None else None
    rows, hidden = x0.shape
    out = torch.empty_like(x0)
    resout = (torch.empty(rows, hidden, dtype=res_dtype, device=x0.device)
              if save_resout else None)
    code = _cuda.lib().xfa_ln_fwd(
        x0.data_ptr(), _cuda.dtype_code(x0),
        residual.data_ptr() if residual is not None else None,
        _cuda.dtype_code(residual) if residual is not None else 0,
        weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), resout.data_ptr() if resout is not None else None,
        _cuda.dtype_code(resout) if resout is not None else 0,
        rows, hidden, float(eps), int(is_rms), _cuda.stream())
    _cuda.check(code, "rms_norm_add")
    ln_fwd.launches += 1
    return out, resout


ln_fwd.launches = 0


def _dropout_add_norm(x0, residual, weight, bias, dropout_p, eps, rowscale,
                      layerscale, prenorm, residual_in_fp32, is_rms):
    if dropout_p > 0.0 or rowscale is not None or layerscale is not None:
        raise NotImplementedError(_NOT_PORTED)
    shape = x0.shape
    h = shape[-1]
    res_dtype = torch.float32 if residual_in_fp32 else x0.dtype
    out, resout = ln_fwd(
        x0.reshape(-1, h),
        residual.reshape(-1, h) if residual is not None else None,
        weight, bias, eps, is_rms, res_dtype, prenorm)
    if prenorm:
        return out.reshape(shape), resout.reshape(shape)
    return out.reshape(shape)


def dropout_add_layer_norm(x0, residual, weight, bias, dropout_p, epsilon,
                           rowscale=None, layerscale=None, prenorm=False,
                           residual_in_fp32=False, seed=None):
    """≙ the TPU package's dropout_add_layer_norm (forward, dropout off)."""
    return _dropout_add_norm(x0, residual, weight, bias, dropout_p, epsilon,
                             rowscale, layerscale, prenorm, residual_in_fp32,
                             is_rms=False)


def dropout_add_rms_norm(x0, residual, weight, bias, dropout_p, epsilon,
                         rowscale=None, layerscale=None, prenorm=False,
                         residual_in_fp32=False, seed=None):
    """≙ the TPU package's dropout_add_rms_norm; bias may be None."""
    return _dropout_add_norm(x0, residual, weight, bias, dropout_p, epsilon,
                             rowscale, layerscale, prenorm, residual_in_fp32,
                             is_rms=True)


def layer_norm(x, weight, bias, epsilon=1e-6):
    return dropout_add_layer_norm(x, None, weight, bias, 0.0, epsilon)


def rms_norm(x, weight, epsilon=1e-6):
    return dropout_add_rms_norm(x, None, weight, None, 0.0, epsilon)
