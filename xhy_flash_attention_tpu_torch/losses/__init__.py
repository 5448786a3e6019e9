from .cross_entropy import CrossEntropyLoss, cross_entropy_loss

__all__ = ["CrossEntropyLoss", "cross_entropy_loss"]
