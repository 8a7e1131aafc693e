"""Trainers of the PyTorch port: stage-1 autoencoder training and stage-2
LDM training."""

from ldm_tf2_tpu_torch.training.ae_trainer import (
    AETrainState, init_ae_train_state, make_adam, make_ae_train_steps,
)
from ldm_tf2_tpu_torch.training.ldm_trainer import (
    AdamW, LDMTrainState, init_ldm_train_state, make_ldm_train_step,
    make_optimizer,
)

__all__ = ["AETrainState", "AdamW", "LDMTrainState", "init_ae_train_state",
           "init_ldm_train_state", "make_adam", "make_ae_train_steps",
           "make_ldm_train_step", "make_optimizer"]
