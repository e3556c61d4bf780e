from .pipeline import (DataConfig, lm_batch, batch_for, class_batch,
                       class_means, ClassTaskConfig,
                       entropy_floor)  # noqa: F401
