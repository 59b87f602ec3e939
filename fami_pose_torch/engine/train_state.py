"""Train state: everything the training loop mutates, in one holder
(``fami_pose_tpu/engine/train_state.py``): the model (parameters and
BatchNorm statistics), the optimizer (its moments), the per-step LR
scheduler and the step counter. The holder is mutable: a train step updates
it in place."""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    step: int = 0

    def state_dict(self):
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": int(self.step),
        }

    def load_state_dict(self, payload):
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
