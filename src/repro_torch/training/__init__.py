from repro_torch.training.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.training.eval import evaluate, filtered_ranks
from repro_torch.training.loop import NGDBTrainer, TrainConfig, incremental_finetune
from repro_torch.training.loss import negative_sampling_loss
from repro_torch.training.optim import AdamConfig, adam_init, adam_update, global_norm

__all__ = [
    "NGDBTrainer",
    "TrainConfig",
    "incremental_finetune",
    "AdamConfig",
    "adam_init",
    "adam_update",
    "global_norm",
    "negative_sampling_loss",
    "evaluate",
    "filtered_ranks",
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
]
