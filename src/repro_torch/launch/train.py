"""Training launcher: the fault-tolerant ``Trainer`` on the synthetic
chain task, printing one JSON line (the reference's
``repro.launch.train``, with its flags, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --optimizer adafactor --steps 8 --ckpt-dir CKPT_DIR

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --batch 4 --seq 32

Runs on ``cuda`` unless ``--device cpu``.  ``--cim ternary`` is refused
before anything is built: the ternary matmul kernels have no backward
(``train/step.py``).  ``--cim exact`` trains through the macro-exact
MAC, whose gradient reaches the weights only through the quantization
scales, as in the reference.  A checkpoint already in ``--ckpt-dir``
is resumed.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the JSON line and return it."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="internlm2-1.8b")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced same-family config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-interval", type=int, default=50)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor", "sgd"))
    p.add_argument("--cim", default="float",
                   choices=("float", "ternary", "exact"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from .. import configs, optim, resolve_device
    from ..core.cim_linear import CIMConfig
    from ..data import DataConfig, entropy_floor
    from ..models import registry
    from ..train import Trainer, TrainerConfig
    from ..train.step import TERNARY_REFUSAL

    if args.cim == "ternary":
        p.error(TERNARY_REFUSAL)
    device = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = registry.build(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.param_count() / 1e6:.1f}M device={device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    print(f"data entropy floor ~= {entropy_floor(data_cfg):.3f} nats/token")

    lr = optim.warmup_cosine(args.lr, max(args.steps // 20, 5), args.steps)
    opt = {"adamw": optim.adamw, "adafactor": optim.adafactor,
           "sgd": optim.sgd}[args.optimizer](lr)
    cim = None if args.cim == "float" else CIMConfig(mode=args.cim)

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_interval=args.ckpt_interval,
                         log_interval=args.log_interval,
                         microbatches=args.microbatches, seed=args.seed)
    trainer = Trainer(model, opt, data_cfg, tcfg, cim=cim, device=device)

    t0 = time.monotonic()
    state = trainer.run()
    dt = time.monotonic() - t0
    losses = [h["loss"] for h in trainer.history]
    tok_per_step = args.batch * args.seq
    out = {
        "steps": int(state.step),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(sum(losses[-10:]) / max(len(losses[-10:]), 1), 4),
        "wall_s": round(dt, 1),
        "tokens_per_s": round(tok_per_step * len(losses) / max(dt, 1e-9)),
        "restarts": trainer.restarts,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
