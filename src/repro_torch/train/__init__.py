"""Training on one device (``trainer``) and its fault tolerance
(``fault_tolerance``): the counterparts of ``repro.train``."""
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
