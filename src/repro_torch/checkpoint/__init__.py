from .checkpoint import (save, restore, latest_step, available_steps,
                         gc_old_steps, CheckpointManager)  # noqa: F401
