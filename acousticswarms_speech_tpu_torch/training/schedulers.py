"""Reduce-on-plateau learning-rate schedule.

Host Python, copied from the JAX package's `training/schedulers.py` for the
PyTorch port (the port imports nothing of that package).  It is not
`torch.optim.lr_scheduler.ReduceLROnPlateau`, whose threshold and warm-up
semantics differ from `dont_halve_until_epoch` here.

Counterpart of the speechbrain `ReduceLROnPlateau` used by the reference
trainer (reference sep/training/train.py:163-167, 207-208): called once
per epoch with the validation loss; halves (by `factor`) when the loss has
not improved for `patience` consecutive epochs, never before
`dont_halve_until_epoch`, floored at `lr_min`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr_min: float = 1e-8
    factor: float = 0.5
    patience: int = 3
    dont_halve_until_epoch: int = 30

    best_loss: float = float("inf")
    bad_epochs: int = 0

    def __call__(self, current_lr: float, epoch: int, loss: float):
        """Returns (current_lr, next_lr)."""
        next_lr = current_lr
        if loss < self.best_loss:
            self.best_loss = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if epoch >= self.dont_halve_until_epoch and self.bad_epochs > self.patience:
            next_lr = current_lr * self.factor
            self.bad_epochs = 0
        next_lr = max(next_lr, self.lr_min)
        return current_lr, next_lr

    def state_dict(self) -> dict:
        return {"best_loss": self.best_loss, "bad_epochs": self.bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.best_loss = state["best_loss"]
        self.bad_epochs = state["bad_epochs"]
