"""Training harness (≙ xhy_flash_attention_tpu training/): config tree ->
Trainer -> one train step per batch on one device, with the repository's
native memmap data loader, exact resume, and speed / FLOPs monitors."""

from ..losses import CrossEntropyLoss, cross_entropy_loss
from .config import TrainConfig, load_config
from .data import LMDataModule, TokenDataset, build_token_cache
from .train import Trainer, train

__all__ = ["CrossEntropyLoss", "LMDataModule", "TokenDataset", "TrainConfig",
           "Trainer", "build_token_cache", "cross_entropy_loss",
           "load_config", "train"]
