from posterior_matching_torch.train.state import (
    TrainState,
    load_train_state,
    save_train_state,
)

__all__ = ["TrainState", "load_train_state", "save_train_state"]
