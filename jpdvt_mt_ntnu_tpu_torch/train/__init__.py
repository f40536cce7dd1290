from .checkpoint import CheckpointManager  # noqa: F401
from .state import (AdamState, AdamW, TrainState, create_train_state,  # noqa: F401
                    fused_adamw_ema, make_optimizer)
from .steps import TrainTask, make_train_step  # noqa: F401
