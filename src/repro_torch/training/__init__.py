from repro_torch.training.optimizer import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, make_schedule,
)
from repro_torch.training.losses import next_token_loss, distill_loss  # noqa: F401
from repro_torch.training.step import (  # noqa: F401
    TrainState, make_train_step, make_distill_step, train_state_init,
)
