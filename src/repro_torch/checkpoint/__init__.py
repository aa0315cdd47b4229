"""Checkpoints of the port, in the reference's file format
(``repro/checkpoint/``)."""
from repro_torch.checkpoint.ckpt import (
    restore_pytree, restore_train_state, save_pytree, save_train_state)

__all__ = ["restore_pytree", "restore_train_state", "save_pytree",
           "save_train_state"]
