from .step import (TrainState, init_state, make_abstract_state,  # noqa: F401
                   make_train_step, place_state, value_and_grad)
from .runner import (Trainer, TrainerConfig, FailurePlan,
                     SimulatedFailure)  # noqa: F401
