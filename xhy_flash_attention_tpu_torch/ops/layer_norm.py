"""Fused dropout + residual add + LayerNorm / RMSNorm, forward and backward
(≙ xhy_flash_attention_tpu ops/layer_norm.py).

    x1           = x0 * rowscale * colscale   (stochastic depth / LayerScale)
    xd           = dropout(x1, p) / (1 - p)
    residual_out = xd + residual              (fp32 if residual_in_fp32)
    out          = norm(residual_out) * weight + bias

prenorm returns (out, residual_out). On a CUDA tensor the work runs in the
kernels of csrc/rms_norm_add.cu (the counterparts of the TPU kernels
`_ln_fwd_kernel`, layer_norm.py:48, and `_ln_bwd_kernel`, layer_norm.py:102);
on a CPU tensor in their plain versions :func:`ln_fwd_ref` and
:func:`ln_bwd_ref`. When an input needs a gradient the call is an autograd
function, as the TPU package's custom VJP: the forward saves residual_out,
the row mean and 1/std (and x0 when there is a layerscale), and the backward
kernel computes dx0, dresidual and the dgamma / dbeta / dlayerscale partials.

The keep mask is ops common.py's ``dropout_keep_mask(seed, 0, row, col,
p)`` on the global (row, col) of the flattened (rows, hidden) input, bit for
bit the TPU kernel's (its layer_norm.py:64-76), so the backward regenerates
it and no mask is stored. The seed's low 32 bits are used (the TPU package
takes an int32 seed and rejects others). rowscale gets no gradient, as in
the TPU package; layerscale (the kernels' colscale) does.

The parallel-residual and subset norms are plain PyTorch around the fused
call, as the TPU package puts XLA ops around its kernel (its
layer_norm.py:431-509).
"""

from __future__ import annotations

import collections
import math

import torch

from . import _cuda
from .flash_attention.common import Dropout, dropout_keep_mask

__all__ = [
    "dropout_add_layer_norm",
    "dropout_add_layer_norm_parallel_residual",
    "dropout_add_layer_norm_subset",
    "dropout_add_rms_norm",
    "dropout_add_rms_norm_parallel_residual",
    "layer_norm",
    "ln_bwd",
    "ln_bwd_ref",
    "ln_fwd",
    "ln_fwd_ref",
    "rms_norm",
]

# Rows per block of the backward kernel: at most 64, and enough blocks for
# two per SM of an H100 (132 SMs) where there are rows for them.
_BWD_BLOCKS_WANTED = 264


def norm_keep_mask(seed: int, dropout_p: float, rows: int, hidden: int,
                   device=None) -> torch.Tensor:
    """The (rows, hidden) keep mask of the fused norm's dropout (True =
    keep): salt 0, the global row and column."""
    return dropout_keep_mask(
        seed, 0, torch.arange(rows, device=device)[:, None],
        torch.arange(hidden, device=device)[None, :], dropout_p)


def _drop(x, seed, dropout_p):
    """x (rows, hidden, fp32) with the keep mask applied and the kept
    elements scaled by 1 / (1 - p), in the TPU kernel's order."""
    keep = norm_keep_mask(seed, dropout_p, *x.shape, device=x.device)
    return torch.where(keep, x, 0.0) * (1.0 / (1.0 - dropout_p))


def ln_fwd_ref(x0, residual, weight, bias, eps: float, is_rms: bool,
               res_dtype: torch.dtype, save_resout: bool,
               save_stats: bool = False, *, rowscale=None, colscale=None,
               dropout_p: float = 0.0, seed=None):
    """Plain version of the forward kernel on (rows, hidden) inputs: the
    same fp32 arithmetic, in the same order. ``rowscale`` (rows,),
    ``colscale`` (hidden,), dropout at ``dropout_p`` keyed on ``seed`` (an
    int). Returns (out, residual_out | None), and with ``save_stats`` also
    the fp32 (rows,) mean (None for RMSNorm) and 1/std."""
    x = x0.float()
    if rowscale is not None:
        x = x * rowscale.float()[:, None]
    if colscale is not None:
        x = x * colscale.float()
    if dropout_p > 0.0:
        x = _drop(x, seed, dropout_p)
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


def _scales(rowscale, colscale, rows, hidden):
    """rowscale and colscale as contiguous fp32, checked against (rows,
    hidden)."""
    if rowscale is not None:
        if rowscale.shape != (rows,):
            raise ValueError(f"rowscale {tuple(rowscale.shape)} is not "
                             f"({rows},)")
        rowscale = rowscale.float().contiguous()
    if colscale is not None:
        if colscale.shape != (hidden,):
            raise ValueError(f"colscale {tuple(colscale.shape)} is not "
                             f"({hidden},)")
        colscale = colscale.float().contiguous()
    return rowscale, colscale


def norm_instance(is_rms: bool, rowscale: bool, colscale: bool) -> str:
    """The name of a dropout instantiation of #7 / #8 in the launch counts:
    the norm and the other flags it takes ("layer_norm",
    "rms_norm rowscale colscale")."""
    return " ".join(["rms_norm" if is_rms else "layer_norm"]
                    + ["rowscale"] * rowscale + ["colscale"] * colscale)


def ln_fwd(x0, residual, weight, bias, eps: float, is_rms: bool,
           res_dtype: torch.dtype, save_resout: bool,
           save_stats: bool = False, *, rowscale=None, colscale=None,
           dropout_p: float = 0.0, seed=None):
    """Kernel wrapper on (rows, hidden) inputs; see :func:`ln_fwd_ref`.

    ``ln_fwd.launches`` counts kernel launches, and
    ``ln_fwd.dropout_launches`` those with dropout by instantiation
    (:func:`norm_instance`).
    """
    flags = dict(rowscale=rowscale, colscale=colscale, dropout_p=dropout_p,
                 seed=seed)
    if x0.device.type == "cpu":
        return ln_fwd_ref(x0, residual, weight, bias, eps, is_rms, res_dtype,
                          save_resout, save_stats, **flags)
    tensors = [t for t in (x0, residual, weight, bias, rowscale, colscale)
               if t is not None]
    _cuda.require_cuda(*tensors)
    if x0.dim() != 2 or weight.shape != (x0.shape[1],):
        raise ValueError(f"x0 {tuple(x0.shape)} and weight "
                         f"{tuple(weight.shape)} do not match")
    if residual is not None and residual.shape != x0.shape:
        raise ValueError("residual must have x0's shape")
    rows, hidden = x0.shape
    rowscale, colscale = _scales(rowscale, colscale, rows, hidden)
    drop = Dropout.c_args(Dropout.make(dropout_p, seed))
    x0 = x0.contiguous()
    residual = residual.contiguous() if residual is not None else None
    weight = weight.float().contiguous()
    bias = bias.float().contiguous() if bias is not None else None
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
        _cuda.ptr(rowscale), _cuda.ptr(colscale), *drop, _cuda.stream())
    _cuda.check(code, "rms_norm_add")
    ln_fwd.launches += 1
    if drop[0]:
        ln_fwd.dropout_launches[norm_instance(
            is_rms, rowscale is not None, colscale is not None)] += 1
    return (out, resout, mu, rstd) if save_stats else (out, resout)


ln_fwd.launches = 0
ln_fwd.dropout_launches = collections.Counter()


def ln_bwd_ref(dout, dres_in, resout, mu, rstd, weight, *, is_rms: bool,
               has_bias: bool, x0_dtype: torch.dtype, res_dtype, x0=None,
               rowscale=None, colscale=None, dropout_p: float = 0.0,
               seed=None):
    """Plain version of the backward kernel on (rows, hidden) inputs, with
    the TPU kernel's arithmetic (layer_norm.py:118-163). ``res_dtype`` is
    the forward residual's dtype, None when it had none; ``x0`` is needed
    with a ``colscale``; the keep mask is regenerated from ``seed``.
    Returns (dx0, dresidual | None, dgamma fp32, dbeta fp32 | None,
    dcolscale fp32 | None)."""
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
    dx = dres
    if dropout_p > 0.0:
        dx = _drop(dx, seed, dropout_p)
    dcolscale = None
    if colscale is not None:
        xs = x0.float()
        if rowscale is not None:
            xs = xs * rowscale.float()[:, None]
        dcolscale = (dx * xs).sum(0)
        dx = dx * colscale.float()
    if rowscale is not None:
        dx = dx * rowscale.float()[:, None]
    return (dx.to(x0_dtype),
            None if res_dtype is None else dres.to(res_dtype), dgamma, dbeta,
            dcolscale)


def ln_bwd(dout, dres_in, resout, mu, rstd, weight, *, is_rms: bool,
           has_bias: bool, x0_dtype: torch.dtype, res_dtype, x0=None,
           rowscale=None, colscale=None, dropout_p: float = 0.0, seed=None):
    """Kernel wrapper of the backward on (rows, hidden) inputs; see
    :func:`ln_bwd_ref`. The kernel writes fp32 dgamma / dbeta / dcolscale
    partials, one row per block of rows, summed here in a fixed order.

    ``ln_bwd.launches`` counts kernel launches, and
    ``ln_bwd.dropout_launches`` those with dropout by instantiation
    (:func:`norm_instance`).
    """
    kw = dict(is_rms=is_rms, has_bias=has_bias, x0_dtype=x0_dtype,
              res_dtype=res_dtype, x0=x0, rowscale=rowscale,
              colscale=colscale, dropout_p=dropout_p, seed=seed)
    if dout.device.type == "cpu":
        return ln_bwd_ref(dout, dres_in, resout, mu, rstd, weight, **kw)
    tensors = [t for t in (dout, dres_in, resout, mu, rstd, weight, x0,
                           rowscale, colscale) if t is not None]
    _cuda.require_cuda(*tensors)
    rows, hidden = dout.shape
    if resout.shape != dout.shape or rstd.shape != (rows,) or (
            not is_rms and mu.shape != (rows,)):
        raise ValueError("dout, residual_out and the saved stats disagree")
    rowscale, colscale = _scales(rowscale, colscale, rows, hidden)
    if colscale is not None:
        if x0 is None or x0.shape != dout.shape:
            raise ValueError("a colscale's gradient needs x0 of dout's shape")
        x0 = x0.contiguous()
    else:
        x0 = None
    drop = Dropout.c_args(Dropout.make(dropout_p, seed))
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
    dcol = torch.empty_like(dgamma) if colscale is not None else None
    code = _cuda.lib().xfa_ln_bwd(
        dout.data_ptr(), _cuda.dtype_code(dout), _cuda.ptr(dres_in),
        _cuda.dtype_code(dres_in) if dres_in is not None else 0,
        resout.data_ptr(), _cuda.dtype_code(resout), _cuda.ptr(mu),
        rstd.data_ptr(), weight.data_ptr(), dx0.data_ptr(),
        _cuda.dtype_code(dx0), _cuda.ptr(dres),
        _cuda.dtype_code(dres) if dres is not None else 0,
        dgamma.data_ptr(), _cuda.ptr(dbeta), rows, hidden, per_block,
        int(is_rms), _cuda.ptr(x0),
        _cuda.dtype_code(x0) if x0 is not None else 0, _cuda.ptr(rowscale),
        _cuda.ptr(colscale), _cuda.ptr(dcol), *drop, _cuda.stream())
    _cuda.check(code, "ln_bwd")
    ln_bwd.launches += 1
    if drop[0]:
        ln_bwd.dropout_launches[norm_instance(
            is_rms, rowscale is not None, colscale is not None)] += 1
    return (dx0, dres, dgamma.sum(0),
            dbeta.sum(0) if dbeta is not None else None,
            dcol.sum(0) if dcol is not None else None)


ln_bwd.launches = 0
ln_bwd.dropout_launches = collections.Counter()


class _AddNorm(torch.autograd.Function):
    """The fused dropout-add-norm on (rows, hidden) inputs with its backward
    (≙ the TPU package's `_dropout_add_norm` custom VJP)."""

    @staticmethod
    def forward(ctx, x0, residual, weight, bias, rowscale, colscale, eps,
                is_rms, prenorm, res_dtype, dropout_p, seed):
        flags = dict(rowscale=rowscale, colscale=colscale,
                     dropout_p=dropout_p, seed=seed)
        out, resout, mu, rstd = ln_fwd(x0, residual, weight, bias, eps,
                                       is_rms, res_dtype, True, True, **flags)
        ctx.save_for_backward(resout, mu, rstd, weight, rowscale, colscale,
                              x0 if colscale is not None else None)
        ctx.kw = dict(is_rms=is_rms, has_bias=bias is not None,
                      x0_dtype=x0.dtype,
                      res_dtype=None if residual is None else residual.dtype,
                      dropout_p=dropout_p, seed=seed)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.prenorm = prenorm
        return (out, resout) if prenorm else out

    @staticmethod
    def backward(ctx, dout, dres_in=None):
        resout, mu, rstd, weight, rowscale, colscale, x0 = ctx.saved_tensors
        dx0, dres, dgamma, dbeta, dcol = ln_bwd(
            dout, dres_in if ctx.prenorm else None, resout, mu, rstd, weight,
            x0=x0, rowscale=rowscale, colscale=colscale, **ctx.kw)
        return (dx0, dres, dgamma.to(weight.dtype),
                None if dbeta is None else dbeta.to(ctx.bias_dtype), None,
                None if dcol is None else dcol.to(colscale.dtype),
                None, None, None, None, None, None)


def _seed32(seed) -> int:
    """The seed's low 32 bits (an int or a one-element int tensor, read on
    the host)."""
    return int(seed) & 0xFFFFFFFF


def _dropout_add_norm(x0, residual, weight, bias, dropout_p, eps, rowscale,
                      layerscale, prenorm, residual_in_fp32, is_rms, seed):
    dropout_p = float(dropout_p)
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError("dropout_p > 0 requires a seed")
        seed = _seed32(seed)
    else:
        dropout_p, seed = 0.0, None
    shape = x0.shape
    h = shape[-1]
    res_dtype = torch.float32 if residual_in_fp32 else x0.dtype
    x0f = x0.reshape(-1, h)
    resf = residual.reshape(-1, h) if residual is not None else None
    rsf = rowscale.reshape(-1) if rowscale is not None else None
    if rsf is not None and rsf.numel() != x0f.shape[0]:
        raise ValueError(f"rowscale {tuple(rowscale.shape)} does not match "
                         f"x0 {tuple(shape)}")
    if layerscale is not None and layerscale.shape != (h,):
        raise ValueError(f"layerscale {tuple(layerscale.shape)} does not "
                         f"match x0 {tuple(shape)}")
    inputs = (x0, residual, weight, bias, layerscale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out = _AddNorm.apply(x0f, resf, weight, bias, rsf, layerscale,
                             float(eps), bool(is_rms), bool(prenorm),
                             res_dtype, dropout_p, seed)
        out, resout = out if prenorm else (out, None)
    else:
        out, resout = ln_fwd(x0f, resf, weight, bias, eps, is_rms, res_dtype,
                             prenorm, rowscale=rsf, colscale=layerscale,
                             dropout_p=dropout_p, seed=seed)
    if prenorm:
        return out.reshape(shape), resout.reshape(shape)
    return out.reshape(shape)


def dropout_add_layer_norm(x0, residual, weight, bias, dropout_p, epsilon,
                           rowscale=None, layerscale=None, prenorm=False,
                           residual_in_fp32=False, seed=None):
    """≙ the TPU package's dropout_add_layer_norm; differentiable in x0,
    residual, weight, bias and layerscale. ``dropout_p`` > 0 needs ``seed``
    (``ValueError`` else); rowscale has one value per row of x0."""
    return _dropout_add_norm(x0, residual, weight, bias, dropout_p, epsilon,
                             rowscale, layerscale, prenorm, residual_in_fp32,
                             False, seed)


def dropout_add_rms_norm(x0, residual, weight, bias, dropout_p, epsilon,
                         rowscale=None, layerscale=None, prenorm=False,
                         residual_in_fp32=False, seed=None):
    """≙ the TPU package's dropout_add_rms_norm; bias may be None."""
    return _dropout_add_norm(x0, residual, weight, bias, dropout_p, epsilon,
                             rowscale, layerscale, prenorm, residual_in_fp32,
                             True, seed)


def layer_norm(x, weight, bias, epsilon=1e-6):
    return dropout_add_layer_norm(x, None, weight, bias, 0.0, epsilon)


def rms_norm(x, weight, epsilon=1e-6):
    return dropout_add_rms_norm(x, None, weight, None, 0.0, epsilon)


def dropout_add_layer_norm_parallel_residual(
    x0, x1, residual, weight0, bias0, weight1, bias1, dropout_p, epsilon,
    prenorm=False, residual_in_fp32=False, seed=None, is_rms=False,
):
    """Dual-norm parallel residual (≙ the TPU package's, used by GPT-J /
    NeoX-style blocks): one dropout-add of x0 (+ x1) into the residual
    stream through the fused call with norm0, then norm1 of the returned
    residual (cast to x0's dtype) through the fused call with no residual.
    Returns (out0, out1 | None) and with ``prenorm`` residual_out too."""
    x0s = x0 if x1 is None else x0 + x1.to(x0.dtype)
    fused = dropout_add_rms_norm if is_rms else dropout_add_layer_norm
    out0, resout = fused(
        x0s, residual, weight0, bias0, dropout_p, epsilon,
        prenorm=True, residual_in_fp32=residual_in_fp32, seed=seed,
    )
    out1 = None if weight1 is None else fused(
        resout.to(x0.dtype), None, weight1, bias1, 0.0, epsilon)
    if prenorm:
        return out0, out1, resout
    return out0, out1


def dropout_add_rms_norm_parallel_residual(
    x0, x1, residual, weight0, bias0, weight1, bias1, dropout_p, epsilon,
    prenorm=False, residual_in_fp32=False, seed=None,
):
    return dropout_add_layer_norm_parallel_residual(
        x0, x1, residual, weight0, bias0, weight1, bias1, dropout_p, epsilon,
        prenorm=prenorm, residual_in_fp32=residual_in_fp32, seed=seed,
        is_rms=True,
    )


def dropout_add_layer_norm_subset(
    x0, residual, weight, bias, dropout_p, epsilon,
    layerscale=None, x0_subset=None, out_subset=None,
    rowscale_const=1.0, out_numrows=0,
    prenorm=False, residual_in_fp32=False, seed=None,
):
    """Subset in / out (≙ the TPU package's, for BERT's masked-token head):
    x0's rows, times ``rowscale_const``, are scattered into a zero stream of
    residual's shape at the flattened row indices ``x0_subset`` before the
    fused call; only the ``out_subset`` rows of the normalized output (the
    first ``out_numrows`` of them when nonzero) are returned. ``layerscale``
    is accepted and not applied, as the TPU package's subset drops it
    (ROADMAP queue C)."""
    h = weight.shape[-1]
    if x0_subset is not None:
        n = math.prod(residual.shape[:-1])
        idx = x0_subset.reshape(-1).to(torch.long)
        full = x0.new_zeros(n, h).index_copy(
            0, idx, x0.reshape(-1, h) * rowscale_const)
        x0 = full.reshape(residual.shape)
    elif rowscale_const != 1.0:
        x0 = x0 * rowscale_const
    out = dropout_add_layer_norm(
        x0, residual, weight, bias, dropout_p, epsilon,
        prenorm=prenorm, residual_in_fp32=residual_in_fp32, seed=seed,
    )
    normed, resout = out if prenorm else (out, None)
    if out_subset is not None:
        rows = normed.reshape(-1, h)[out_subset.reshape(-1).to(torch.long)]
        if out_numrows:
            rows = rows[:out_numrows]
        normed = rows
    return (normed, resout) if prenorm else normed
