from .optimizers import (Optimizer, adamw, adafactor, sgd, warmup_cosine,
                         constant_lr, global_norm,
                         clip_by_global_norm)  # noqa: F401
from .compression import (compress_int8, decompress_int8, ef_init,
                          ef_compress_grads,
                          int8_allgather_sync)  # noqa: F401
