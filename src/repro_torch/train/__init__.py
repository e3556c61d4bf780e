from .step import (TrainState, init_state, make_train_step,
                   value_and_grad)  # noqa: F401
from .runner import (Trainer, TrainerConfig, FailurePlan,
                     SimulatedFailure)  # noqa: F401
