"""Training: AdamW, the synthetic token stream, checkpoints and the loop.
Counterpart of `repro.training`, with the reference's public names."""
from .checkpoint import flatten_state, load_checkpoint, save_checkpoint, unflatten_like
from .data import DataConfig, SyntheticTokens
from .optimizer import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from .train_loop import TrainResult, make_train_step, train

__all__ = [
    "flatten_state", "load_checkpoint", "save_checkpoint", "unflatten_like",
    "DataConfig", "SyntheticTokens", "AdamWConfig", "adamw_update",
    "init_opt_state", "lr_schedule", "TrainResult", "make_train_step", "train",
]
