"""Linear layers (≙ xhy_flash_attention_tpu modules/linear.py).

`RowParallelDense` is a plain `nn.Linear` here: tensor parallelism and
weight-only quantization come with later slices. The weight is stored
(out, in), PyTorch's layout; `models.gpt.state_dict_from_jax` transposes
the TPU package's (in, out) kernels.
"""

from torch import nn

__all__ = ["RowParallelDense"]


class RowParallelDense(nn.Linear):
    """The output projection of attention and MLP blocks."""
