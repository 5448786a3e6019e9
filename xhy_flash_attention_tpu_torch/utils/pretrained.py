"""Checkpoint loading (≙ xhy_flash_attention_tpu utils/pretrained.py).

:func:`state_dict_from_pretrained` reads a torch state dict from a local
directory (``model.safetensors`` or ``pytorch_model.bin``) or, for a hub
id, through ``transformers`` (imported only then); values come back as
numpy arrays, as the JAX package returns them. :func:`gpt_params_from_pretrained`
dispatches on the model family to its config translation and remap onto the
GPT skeleton: GPT-2, Llama / Mistral and GPT-NeoX. The other families of
slice 8 (OPT, GPT-J, Falcon) raise NotImplementedError until their models
are ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.flash_attention.common import SLICE_MODELS

__all__ = ["state_dict_from_pretrained", "gpt_params_from_pretrained",
           "MODEL_FAMILIES"]

MODEL_FAMILIES = ("gpt2", "llama", "mistral", "opt", "gptj", "gpt_neox",
                  "falcon")


def state_dict_from_pretrained(model_name: str, device=None, dtype=None
                               ) -> Dict[str, Any]:
    """A checkpoint's state dict as numpy arrays.

    ``model_name``: a local directory holding ``model.safetensors`` or
    ``pytorch_model.bin`` (read as stored; ``FileNotFoundError`` when it
    holds neither), or a hub id, loaded through ``transformers``
    ``AutoModelForCausalLM`` and cast to ``dtype`` (a torch dtype or its
    name) when given. ``device`` is accepted for the JAX package's
    signature and not used."""
    del device
    if os.path.isdir(model_name):
        for fname in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(model_name, fname)
            if not os.path.exists(path):
                continue
            if fname.endswith(".safetensors"):
                from safetensors.numpy import load_file

                return load_file(path)
            sd = torch.load(path, map_location="cpu", weights_only=True)
            return {k: v.numpy() for k, v in sd.items()}
        raise FileNotFoundError(f"no checkpoint found in {model_name}")
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(model_name)
    cast = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return {k: v.to(cast or v.dtype).numpy()
            for k, v in model.state_dict().items()}


def _family_of(model_name: str, hf_config) -> str:
    """The family of a checkpoint from its config's ``model_type`` or its
    name, as the JAX package finds it (mistral is llama's)."""
    mt = getattr(hf_config, "model_type", "")
    for fam in ("llama", "mistral", "opt", "gptj", "gpt_neox", "falcon",
                "gpt2"):
        if fam in mt or fam in model_name.lower():
            return "llama" if fam == "mistral" else fam
    raise ValueError(f"unsupported model family for {model_name} ({mt})")


def gpt_params_from_pretrained(
    model_name: str,
    hf_config,
    state_dict: Optional[Dict[str, Any]] = None,
    dtype=torch.float32,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(GPTConfig, the port's state dict) for a GPT-2, Llama / Mistral or
    GPT-NeoX checkpoint: ``hf_config`` an object with the Hugging Face config's
    field names, ``state_dict`` the checkpoint's (read by
    :func:`state_dict_from_pretrained` when None). Load the result with
    ``GPTLMHeadModel(config, ...).load_state_dict(state_dict)``."""
    from ..models import gpt, gpt_neox, llama

    fam = _family_of(model_name, hf_config)
    table = {
        "gpt2": (gpt.gpt2_config_to_gpt_config, gpt.remap_state_dict_hf_gpt2),
        "llama": (llama.llama_config_to_gpt_config,
                  llama.remap_state_dict_hf_llama),
        "gpt_neox": (gpt_neox.gpt_neox_config_to_gpt_config,
                     gpt_neox.remap_state_dict_hf_gpt_neox),
    }
    if fam not in table:
        raise NotImplementedError(
            f"the {fam} family (its config translation and remap) is not "
            f"ported yet: {SLICE_MODELS}")
    to_config, remap = table[fam]
    cfg = to_config(hf_config, dtype=dtype)
    if state_dict is None:
        state_dict = state_dict_from_pretrained(model_name)
    return cfg, remap(state_dict, cfg)
