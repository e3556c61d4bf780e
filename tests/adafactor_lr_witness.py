"""Does Adafactor's step at the launcher's peak lr of 1e-3 raise zamba2-7b's
loss at its full width, in the reference as in the port?

Both packages train zamba2-7b cut to one group (its first ``attn_every``
Mamba2 layers and the shared block; every width kept) in bf16 from the
same params (the reference's init, carried across by ``convert``) on the
same batches (each package's ``batch_for``), with Adafactor and the
launcher's ``warmup_cosine(peak, 5, steps)``, once at each peak lr.  The
sequence is cut to 64 positions: past about 100 the reference's Mamba2
gradients are not finite (ROADMAP, known faults in the reference).

    PYTHONPATH=src:tests python tests/adafactor_lr_witness.py \\
        [--peaks 1e-3,3e-4] [--steps 6] [--batch 8] [--seq 64] \\
        [--fixed-batch] [--packages reference,port]

Prints one JSON line per package and peak: the loss before each update.
``--fixed-batch`` takes step 0's batch at every step, so that a rise is
the update's and not the next batch's.
It runs on the CPU; one group at full width holds about 0.9 G parameters,
so a run takes some 10 GB and minutes.
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import DataConfig as JDataConfig
from repro.data import batch_for as jbatch_for
from repro.models import registry as jregistry
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs, optim
from repro_torch.convert import params_from_reference
from repro_torch.data import DataConfig, batch_for
from repro_torch.models import registry
from repro_torch.train import TrainState, make_train_step

ARCH = "zamba2-7b"


def reference_losses(jm, jparams, peak, steps, data, fixed):
    jopt = joptim.adafactor(joptim.warmup_cosine(peak, 5, steps))
    state = JTrainState(jparams, jopt.init(jparams),
                        jnp.zeros((), jnp.int32))
    step_fn = jax.jit(jmake_train_step(jm, jopt))
    losses = []
    for step in range(steps):
        state, m = step_fn(state, jbatch_for(jm.cfg, JDataConfig(**data),
                                             0 if fixed else step))
        losses.append(float(m["loss"]))
    return losses


def port_losses(tm, params, peak, steps, data, fixed):
    opt = optim.adafactor(optim.warmup_cosine(peak, 5, steps))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step_fn = make_train_step(tm, opt)
    losses = []
    for step in range(steps):
        state, m = step_fn(state, batch_for(tm.cfg, DataConfig(**data),
                                            0 if fixed else step,
                                            device="cpu"))
        losses.append(float(m["loss"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peaks", default="1e-3,3e-4")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fixed-batch", action="store_true")
    ap.add_argument("--packages", default="reference,port")
    args = ap.parse_args(argv)
    jax.config.update("jax_platform_name", "cpu")
    jcfg = jconfigs.get(ARCH)
    jm = jregistry.build(dataclasses.replace(jcfg,
                                             num_layers=jcfg.attn_every))
    tm = registry.build(dataclasses.replace(configs.get(ARCH),
                                            num_layers=jcfg.attn_every))
    jparams = jm.init(jax.random.key(0))
    data = dict(vocab_size=jcfg.vocab_size, seq_len=args.seq,
                global_batch=args.batch, seed=0)
    runs = {"reference": lambda peak: reference_losses(
        jm, jparams, peak, args.steps, data, args.fixed_batch),
            "port": lambda peak: port_losses(
        tm, params_from_reference(jax.tree.map(np.asarray, jparams),
                                  device="cpu"),
        peak, args.steps, data, args.fixed_batch)}
    for peak in (float(p) for p in args.peaks.split(",")):
        for name in args.packages.split(","):
            t = time.monotonic()
            losses = runs[name](peak)
            print(json.dumps(dict(package=name, arch=ARCH,
                                  layers=jcfg.attn_every, peak_lr=peak,
                                  batch=args.batch, seq=args.seq,
                                  fixed_batch=args.fixed_batch,
                                  losses=losses,
                                  s=round(time.monotonic() - t, 1))),
                  flush=True)


if __name__ == "__main__":
    main()
