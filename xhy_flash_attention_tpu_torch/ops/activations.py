"""Activation functions (≙ xhy_flash_attention_tpu ops/activations.py).
Plain PyTorch."""

import torch.nn.functional as F

__all__ = ["sqrelu", "gelu_tanh", "swiglu", "geglu", "ACTIVATIONS"]


def sqrelu(x):
    r = F.relu(x)
    return r * r


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def swiglu(gate, up):
    return F.silu(gate) * up


def geglu(gate, up):
    return gelu_tanh(gate) * up


# The names modules/mlp.py accepts. "gelu" is the tanh form too, as
# jax.nn.gelu defaults to it in the TPU package.
ACTIVATIONS = {
    "gelu_approx": gelu_tanh,
    "gelu": gelu_tanh,
    "relu": F.relu,
    "sqrelu": sqrelu,
    "silu": F.silu,
}
