from pbs_tpu_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    Replicator,
    checkpoint_exists,
    load_checkpoint,
    remove_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AsyncCheckpointer",
    "Replicator",
    "checkpoint_exists",
    "load_checkpoint",
    "remove_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
]
