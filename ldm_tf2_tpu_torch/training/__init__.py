"""Trainers of the PyTorch port: stage-2 LDM training."""

from ldm_tf2_tpu_torch.training.ldm_trainer import (
    AdamW, LDMTrainState, init_ldm_train_state, make_ldm_train_step,
    make_optimizer,
)

__all__ = ["AdamW", "LDMTrainState", "init_ldm_train_state",
           "make_ldm_train_step", "make_optimizer"]
