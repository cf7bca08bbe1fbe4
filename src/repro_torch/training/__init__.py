from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (OptimizerConfig, apply_updates,
                                            init_optimizer, lr_at)
from repro_torch.training.train_loop import (TrainConfig, compute_loss,
                                             make_train_step)

__all__ = [
    "OptimizerConfig", "init_optimizer", "apply_updates", "lr_at",
    "TrainConfig", "compute_loss", "make_train_step",
    "save_checkpoint", "restore_checkpoint", "latest_checkpoint",
]
