from posterior_matching_torch.train.callbacks import (
    Callback,
    CheckpointCallback,
    LearningRateLoggerCallback,
    SnapshotCallback,
)
from posterior_matching_torch.train.state import (
    TrainState,
    load_train_state,
    save_train_state,
)
from posterior_matching_torch.train.trainer import (
    Trainer,
    pm_vdvae_trainer,
    pm_vqvae_trainer,
    vqvae_trainer,
)

__all__ = ["Callback", "CheckpointCallback", "LearningRateLoggerCallback", "SnapshotCallback",
           "TrainState", "Trainer", "load_train_state",
           "pm_vdvae_trainer", "pm_vqvae_trainer", "save_train_state", "vqvae_trainer"]
