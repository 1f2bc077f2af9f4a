from repro_torch.training.checkpoint import (  # noqa: F401
    CheckpointManager, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.compression import (  # noqa: F401
    compress_gradients, decompress_gradients,
)
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWState, OptConfig, adamw_init, adamw_update, clip_by_global_norm,
    wsd_schedule,
)
from repro_torch.training.train_lib import (  # noqa: F401
    TrainState, init_train_state, make_train_step,
)
