"""Fused residual add + LayerNorm / RMSNorm, forward and backward (≙
xhy_flash_attention_tpu ops/layer_norm.py).

    residual_out = x0 + residual          (fp32 if residual_in_fp32)
    out          = norm(residual_out) * weight + bias

prenorm returns (out, residual_out). On a CUDA tensor the work runs in the
kernels of csrc/rms_norm_add.cu (the counterparts of the TPU kernels
`_ln_fwd_kernel`, layer_norm.py:48, and `_ln_bwd_kernel`, layer_norm.py:102);
on a CPU tensor in their plain versions :func:`ln_fwd_ref` and
:func:`ln_bwd_ref`. When an input needs a gradient the call is an autograd
function, as the TPU package's custom VJP: the forward saves residual_out,
the row mean and 1/std, and the backward kernel computes dx0, dresidual and
the dgamma / dbeta partials. Dropout, rowscale and layerscale wait for
slice 6.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = [
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "layer_norm",
    "ln_bwd",
    "ln_bwd_ref",
    "ln_fwd",
    "ln_fwd_ref",
    "rms_norm",
]

_NOT_PORTED = ("dropout, rowscale and layerscale in the fused norm come with "
               "slice 6 (dropout) (ROADMAP.md, 'Next slices of the port')")

# Rows per block of the backward kernel: at most 64, and enough blocks for
# two per SM of an H100 (132 SMs) where there are rows for them.
_BWD_BLOCKS_WANTED = 264


def ln_fwd_ref(x0, residual, weight, bias, eps: float, is_rms: bool,
               res_dtype: torch.dtype, save_resout: bool,
               save_stats: bool = False):
    """Plain version of the forward kernel on (rows, hidden) inputs: the
    same fp32 arithmetic, in the same order. Returns (out, residual_out |
    None), and with ``save_stats`` also the fp32 (rows,) mean (None for
    RMSNorm) and 1/std."""
    x = x0.float()
    if residual is not None:
        x = x + residual.float()
    if is_rms:
        mu = None
        xc = x
        var = (x * x).mean(-1, keepdim=True)
    else:
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = xc * rstd * weight.float()
    if bias is not None:
        out = out + bias.float()
    out = out.to(x0.dtype)
    resout = x.to(res_dtype) if save_resout else None
    if not save_stats:
        return out, resout
    return out, resout, (None if mu is None else mu[:, 0]), rstd[:, 0]


def ln_fwd(x0, residual, weight, bias, eps: float, is_rms: bool,
           res_dtype: torch.dtype, save_resout: bool,
           save_stats: bool = False):
    """Kernel wrapper on (rows, hidden) inputs; see :func:`ln_fwd_ref`.

    ``ln_fwd.launches`` counts kernel launches.
    """
    if x0.device.type == "cpu":
        return ln_fwd_ref(x0, residual, weight, bias, eps, is_rms, res_dtype,
                          save_resout, save_stats)
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
    stat = dict(dtype=torch.float32, device=x0.device)
    mu = torch.empty(rows, **stat) if save_stats and not is_rms else None
    rstd = torch.empty(rows, **stat) if save_stats else None
    code = _cuda.lib().xfa_ln_fwd(
        x0.data_ptr(), _cuda.dtype_code(x0), _cuda.ptr(residual),
        _cuda.dtype_code(residual) if residual is not None else 0,
        weight.data_ptr(), _cuda.ptr(bias), out.data_ptr(), _cuda.ptr(resout),
        _cuda.dtype_code(resout) if resout is not None else 0,
        _cuda.ptr(mu), _cuda.ptr(rstd), rows, hidden, float(eps), int(is_rms),
        _cuda.stream())
    _cuda.check(code, "rms_norm_add")
    ln_fwd.launches += 1
    return (out, resout, mu, rstd) if save_stats else (out, resout)


ln_fwd.launches = 0


def ln_bwd_ref(dout, dres_in, resout, mu, rstd, weight, *, is_rms: bool,
               has_bias: bool, x0_dtype: torch.dtype, res_dtype):
    """Plain version of the backward kernel on (rows, hidden) inputs, with
    the TPU kernel's arithmetic (layer_norm.py:118-136). ``res_dtype`` is
    the forward residual's dtype, None when it had none. Returns (dx0,
    dresidual | None, dgamma fp32, dbeta fp32 | None)."""
    xhat = resout.float()
    if not is_rms:
        xhat = xhat - mu[:, None]
    xhat = xhat * rstd[:, None]
    g = dout.float()
    dy = g * weight.float()
    c1 = (dy * xhat).mean(-1, keepdim=True)
    if is_rms:
        dres = (dy - xhat * c1) * rstd[:, None]
    else:
        dres = (dy - xhat * c1 - dy.mean(-1, keepdim=True)) * rstd[:, None]
    if dres_in is not None:
        dres = dres + dres_in.float()
    dgamma = (g * xhat).sum(0)
    dbeta = g.sum(0) if has_bias else None
    return (dres.to(x0_dtype),
            None if res_dtype is None else dres.to(res_dtype), dgamma, dbeta)


def ln_bwd(dout, dres_in, resout, mu, rstd, weight, *, is_rms: bool,
           has_bias: bool, x0_dtype: torch.dtype, res_dtype):
    """Kernel wrapper of the backward on (rows, hidden) inputs; see
    :func:`ln_bwd_ref`. The kernel writes fp32 dgamma / dbeta partials, one
    row per block of rows, summed here in a fixed order.

    ``ln_bwd.launches`` counts kernel launches.
    """
    kw = dict(is_rms=is_rms, has_bias=has_bias, x0_dtype=x0_dtype,
              res_dtype=res_dtype)
    if dout.device.type == "cpu":
        return ln_bwd_ref(dout, dres_in, resout, mu, rstd, weight, **kw)
    tensors = [t for t in (dout, dres_in, resout, mu, rstd, weight)
               if t is not None]
    _cuda.require_cuda(*tensors)
    rows, hidden = dout.shape
    if resout.shape != dout.shape or rstd.shape != (rows,) or (
            not is_rms and mu.shape != (rows,)):
        raise ValueError("dout, residual_out and the saved stats disagree")
    dout = dout.contiguous()
    dres_in = dres_in.contiguous() if dres_in is not None else None
    resout = resout.contiguous()
    weight = weight.float().contiguous()
    per_block = max(1, min(64, -(-rows // _BWD_BLOCKS_WANTED)))
    blocks = -(-rows // per_block)
    dev = dout.device
    dx0 = torch.empty(rows, hidden, dtype=x0_dtype, device=dev)
    dres = (torch.empty(rows, hidden, dtype=res_dtype, device=dev)
            if res_dtype is not None else None)
    dgamma = torch.empty(blocks, hidden, dtype=torch.float32, device=dev)
    dbeta = torch.empty_like(dgamma) if has_bias else None
    code = _cuda.lib().xfa_ln_bwd(
        dout.data_ptr(), _cuda.dtype_code(dout), _cuda.ptr(dres_in),
        _cuda.dtype_code(dres_in) if dres_in is not None else 0,
        resout.data_ptr(), _cuda.dtype_code(resout), _cuda.ptr(mu),
        rstd.data_ptr(), weight.data_ptr(), dx0.data_ptr(),
        _cuda.dtype_code(dx0), _cuda.ptr(dres),
        _cuda.dtype_code(dres) if dres is not None else 0,
        dgamma.data_ptr(), _cuda.ptr(dbeta), rows, hidden, per_block,
        int(is_rms), _cuda.stream())
    _cuda.check(code, "ln_bwd")
    ln_bwd.launches += 1
    return (dx0, dres, dgamma.sum(0),
            dbeta.sum(0) if dbeta is not None else None)


ln_bwd.launches = 0


class _AddNorm(torch.autograd.Function):
    """The fused add-norm on (rows, hidden) inputs with its backward (≙ the
    TPU package's `_dropout_add_norm` custom VJP, dropout off)."""

    @staticmethod
    def forward(ctx, x0, residual, weight, bias, eps, is_rms, prenorm,
                res_dtype):
        out, resout, mu, rstd = ln_fwd(x0, residual, weight, bias, eps,
                                       is_rms, res_dtype, True, True)
        ctx.save_for_backward(resout, mu, rstd, weight)
        ctx.kw = dict(is_rms=is_rms, has_bias=bias is not None,
                      x0_dtype=x0.dtype,
                      res_dtype=None if residual is None else residual.dtype)
        ctx.prenorm = prenorm
        return (out, resout) if prenorm else out

    @staticmethod
    def backward(ctx, dout, dres_in=None):
        resout, mu, rstd, weight = ctx.saved_tensors
        dx0, dres, dgamma, dbeta = ln_bwd(
            dout, dres_in if ctx.prenorm else None, resout, mu, rstd, weight,
            **ctx.kw)
        return (dx0, dres, dgamma.to(weight.dtype),
                None if dbeta is None else dbeta, None, None, None, None)


def _dropout_add_norm(x0, residual, weight, bias, dropout_p, eps, rowscale,
                      layerscale, prenorm, residual_in_fp32, is_rms):
    if dropout_p > 0.0 or rowscale is not None or layerscale is not None:
        raise NotImplementedError(_NOT_PORTED)
    shape = x0.shape
    h = shape[-1]
    res_dtype = torch.float32 if residual_in_fp32 else x0.dtype
    x0f = x0.reshape(-1, h)
    resf = residual.reshape(-1, h) if residual is not None else None
    inputs = (x0, residual, weight, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out = _AddNorm.apply(x0f, resf, weight, bias, float(eps),
                             bool(is_rms), bool(prenorm), res_dtype)
        out, resout = out if prenorm else (out, None)
    else:
        out, resout = ln_fwd(x0f, resf, weight, bias, eps, is_rms, res_dtype,
                             prenorm)
    if prenorm:
        return out.reshape(shape), resout.reshape(shape)
    return out.reshape(shape)


def dropout_add_layer_norm(x0, residual, weight, bias, dropout_p, epsilon,
                           rowscale=None, layerscale=None, prenorm=False,
                           residual_in_fp32=False, seed=None):
    """≙ the TPU package's dropout_add_layer_norm (dropout off);
    differentiable in x0, residual, weight and bias."""
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
