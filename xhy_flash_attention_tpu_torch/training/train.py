"""Training on one device (≙ xhy_flash_attention_tpu training/train.py
`Trainer` and `train`).

One step: the model's forward in its compute dtype, the cross-entropy loss,
autograd's backward (through the attention, norm and loss backwards), the
global gradient norm, then clip -> AdamW on fp32 master weights. Precision
as in the JAX package, where flax keeps fp32 parameters and computes in
``cfg.dtype``: here the model holds the compute copies (bf16 linear and
embedding weights; norm weights stay fp32), and the Trainer owns the fp32
masters and the AdamW moments, writing the compute copies back after every
update. Checkpoints store the masters, the moments, the data cursor and the
token count, so a resumed run lands bitwise on the same parameters.

Runs on ``cuda`` unless the caller passes ``device="cpu"`` (the tests).
A recipe's ``model.remat`` / ``model.remat_policy`` rematerialise each
block (models/gpt.py). Parallel training (a mesh other than (1, 1),
pipeline stages) comes with slice 9, the vision task with slice 8, fp32
compute on the card with slice 7b.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..losses.cross_entropy import cross_entropy_loss
from ..models.gpt import GPTConfig, GPTLMHeadModel
from .callbacks import (NumTokens, Perplexity, SpeedMonitor,
                        gpt_flops_per_token, peak_flops)
from .config import TrainConfig, load_config, model_dtype
from .data import LMDataModule
from .optim import make_optimizer

__all__ = ["Trainer", "train"]

_NEXT = "(ROADMAP.md, 'Next slices of the port')"
_PDROP = ("embd_pdrop", "resid_pdrop", "attn_pdrop")


def _model_config(model: Dict, dtype: torch.dtype) -> GPTConfig:
    """The config's ``model`` tree as this port's GPTConfig, ``remat`` and
    ``remat_policy`` included. The dropout rates are dropped: the JAX
    Trainer applies the model with deterministic=True (train.py:152-158),
    so it never drops out either."""
    model = {k: v for k, v in model.items() if k not in _PDROP}
    return GPTConfig(**{**model, "dtype": dtype})


class Trainer:
    def __init__(self, cfg: TrainConfig, *, device="cuda"):
        if cfg.task != "lm":
            raise NotImplementedError(
                f"task {cfg.task!r}: the vision trainer comes with slice 8 "
                f"(the other models and the vision trainer) {_NEXT}")
        if tuple(cfg.mesh) != (1, 1) or cfg.pipeline_parallel > 1:
            raise NotImplementedError(
                f"mesh {tuple(cfg.mesh)}, pipeline_parallel "
                f"{cfg.pipeline_parallel}: parallel training comes with "
                f"slice 9 (parallelism) {_NEXT}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = model_dtype(cfg)
        self.model_cfg = _model_config(cfg.model, self.dtype)
        self.model = GPTLMHeadModel(self.model_cfg, device=self.device,
                                    seed=cfg.seed)
        self.data = LMDataModule(
            cfg.data.path, cfg.data.seqlen, cfg.data.batch_size,
            seed=cfg.data.seed, dtype=np.dtype(cfg.data.dtype),
        )
        self.opt = make_optimizer(cfg.optimizer, cfg.scheduler)
        self.step = 0
        self.num_tokens = NumTokens()
        self.ppl = Perplexity()
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state = None
        self.history = []  # one dict per step of fit()

    # ---- setup ----------------------------------------------------------

    def _set_params(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Take fp32 master values: an fp32 model parameter is its own
        master; a lower-precision one gets an fp32 copy."""
        self.params = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                src = tensors[name].to(self.device, torch.float32)
                if p.dtype == torch.float32:
                    p.copy_(src)
                    self.params[name] = p.detach()
                else:
                    self.params[name] = src.clone()
        self._sync_model()

    def _sync_model(self) -> None:
        """Write the masters into the model's compute copies."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                master = self.params[name]
                if master.data_ptr() != p.data_ptr():
                    p.copy_(master)

    def init_params(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        """Masters from ``state_dict`` (e.g. `state_dict_from_jax`'s), else
        from the model's own random weights; fresh AdamW state."""
        if state_dict is None:
            state_dict = dict(self.model.named_parameters())
        self._set_params(state_dict)
        self.opt_state = self.opt.init(self.params)

    def _batch(self, ids, labels):
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, torch.long)
        return to(ids), to(labels)

    def _loss_fn(self, ids, labels):
        logits, _ = self.model(ids)
        losses = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                    labels.reshape(-1))
        return losses.mean()

    def compute_grads(self, ids, labels):
        """Loss and fp32 gradients of one batch, without an update."""
        for p in self.model.parameters():
            p.grad = None
        loss = self._loss_fn(ids, labels)
        loss.backward()
        grads = {n: p.grad.float() for n, p in self.model.named_parameters()}
        return loss.detach(), grads

    def train_step(self, ids, labels):
        """One update; returns (loss, grad norm before clipping)."""
        loss, grads = self.compute_grads(ids, labels)
        gnorm = self.opt.update(grads, self.opt_state, self.params)
        self._sync_model()
        return loss, gnorm

    # ---- checkpointing --------------------------------------------------

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.cfg.ckpt_dir,
                                    f"step_{self.step}.ckpt")
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}
        state = {k: (cpu(v) if isinstance(v, dict) else v)
                 for k, v in self.opt_state.items()}
        payload = {
            "step": self.step,
            "params": cpu(self.params),
            "opt_state": state,
            "data": self.data.state_dict(),
            "num_tokens": self.num_tokens.state_dict(),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic
        last = os.path.join(os.path.dirname(path), "last.ckpt")
        try:
            if os.path.islink(last) or os.path.exists(last):
                os.remove(last)
            os.symlink(os.path.basename(path), last)
        except OSError:
            pass
        return path

    def load_checkpoint(self, path: str):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.step = payload["step"]
        self._set_params(payload["params"])
        self.opt_state = {
            k: ({n: t.to(self.device) for n, t in v.items()}
                if isinstance(v, dict) else v)
            for k, v in payload["opt_state"].items()}
        self.data.load_state_dict(payload["data"])
        self.num_tokens.load_state_dict(payload["num_tokens"])

    def maybe_resume(self) -> bool:
        last = os.path.join(self.cfg.ckpt_dir, "last.ckpt")
        if self.cfg.resume and os.path.exists(last):
            self.load_checkpoint(os.path.realpath(last))
            return True
        return False

    # ---- eval and profiling ---------------------------------------------

    def _ready(self):
        if self.params is None and not self.maybe_resume():
            self.init_params()

    @torch.no_grad()
    def evaluate(self, data: Optional[LMDataModule] = None,
                 max_batches: int = 50) -> dict:
        """Held-out loss and perplexity over ``max_batches`` batches."""
        data = data or self.data
        self._ready()
        ppl = Perplexity()
        it = iter(data)
        tokens_per_batch = data.batch_size * data.seqlen
        for _ in range(max_batches):
            loss = float(self._loss_fn(*self._batch(*next(it))))
            ppl.update(loss * tokens_per_batch, tokens_per_batch)
        return {"eval_loss": ppl.total_nll / max(ppl.total_tokens, 1),
                "eval_ppl": ppl.compute()}

    def profile_step(self, trace_dir: str = "xfa_train_trace") -> str:
        """A torch.profiler trace of one train step, after one step
        outside the trace; the chrome trace lands in ``trace_dir``."""
        from torch.profiler import ProfilerActivity, profile
        self._ready()
        it = iter(self.data)
        self.train_step(*self._batch(*next(it)))
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            loss, _ = self.train_step(*self._batch(*next(it)))
            float(loss)
        self.step += 2
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "train_step.json"))
        return trace_dir

    # ---- loop -------------------------------------------------------------

    def fit(self, max_steps: Optional[int] = None,
            log: Callable[[str], None] = print) -> float:
        cfg = self.cfg
        max_steps = max_steps or cfg.max_steps
        self._ready()
        tokens_per_step = cfg.data.batch_size * cfg.data.seqlen
        mc = self.model_cfg
        speed = SpeedMonitor(
            tokens_per_step,
            gpt_flops_per_token(
                mc.num_hidden_layers, mc.hidden_size, cfg.data.seqlen,
                mc.padded_vocab_size,
                mc.intermediate_size or 4 * mc.hidden_size,
            ),
            peak_flops(self.device),
        )
        it = iter(self.data)
        loss_f = float("nan")
        while self.step < max_steps:
            loss, gnorm = self.train_step(*self._batch(*next(it)))
            self.step += 1
            self.num_tokens.update(tokens_per_step)
            loss_f = float(loss)  # waits for the step
            stats = speed.step()
            self.ppl.update(loss_f * tokens_per_step, tokens_per_step)
            self.history.append({"step": self.step, "loss": loss_f,
                                 "grad_norm": float(gnorm), **stats})
            if self.step % cfg.log_every == 0:
                log(f"step {self.step} loss {loss_f:.4f} "
                    f"gnorm {float(gnorm):.3f} "
                    f"ppl {self.ppl.compute():.2f} "
                    + " ".join(f"{k} {v:.3f}" for k, v in stats.items()))
            if cfg.ckpt_every and self.step % cfg.ckpt_every == 0:
                self.save_checkpoint()
        return loss_f


def train(config_path: str, *, device="cuda",
          log: Callable[[str], None] = print, **overrides) -> Trainer:
    """CLI-style entry: load ``config_path`` with dotted-key ``overrides``
    (e.g. ``**{"data.path": ..., "max_steps": 6}``), build the Trainer on
    ``device`` and fit. Returns the Trainer."""
    cfg = load_config(config_path, overrides or None)
    t = Trainer(cfg, device=device)
    t.fit(log=log)
    return t
