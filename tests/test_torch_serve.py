"""The PyTorch port's bucket ServeEngine against the JAX reference's, on
the CPU at f32 smoke size: six requests in two prompt-length buckets,
per-request budgets, and an EOS id that fires mid-decode.

Bars: identical tokens per request; ``host_transfers == buckets`` for the
on-device loop; the same ``steps_run``; the legacy per-step loop gives
the same tokens; ``latency_stats`` and ``percentile`` equal.
"""
import dataclasses
import json
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import latency_stats as jlatency_stats
from repro.serve.engine import percentile as jpercentile
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.models import registry
from repro_torch.serve import Request, ServeEngine, latency_stats, percentile

jax.config.update("jax_platform_name", "cpu")

LENGTHS = [5, 5, 7, 5, 7, 7]         # two buckets: uids 0,1,3 and 2,4,5
MAX_NEW = [6, 3, 5, 4, 6, 2]
CAP = 16


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jternarize(jax.jit(jm.init)(jax.random.key(3)),
                         JCIMConfig(mode="ternary", packing="base3"))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in LENGTHS]
    return jm, tm, jparams, tparams, prompts


def _serve_reference(eos):
    jm, _, jparams, _, prompts = _setup()
    eng = JServeEngine(jm, jparams, capacity=CAP, max_batch=4,
                       cim=JCIMConfig(mode="ternary", packing="base3",
                                      backend="xla"))
    for i, p in enumerate(prompts):
        eng.submit(JRequest(uid=i, prompt=jnp.asarray(p), max_new=MAX_NEW[i],
                            eos_id=eos[i]))
    done = eng.run()
    return {r.uid: r.out_tokens for r in done}, eng


def _serve_port(eos, on_device_loop=True):
    _, tm, _, tparams, prompts = _setup()
    eng = ServeEngine(tm, tparams, capacity=CAP, max_batch=4,
                      cim=CIMConfig(mode="ternary", packing="base3"),
                      on_device_loop=on_device_loop, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW[i],
                           eos_id=eos[i]))
    done = eng.run()
    return {r.uid: r.out_tokens for r in done}, eng


@functools.lru_cache(maxsize=None)
def _eos_that_fires():
    """Request 0 stops at its third token, request 2 at its second (the
    ids come from a run without EOS; the test then holds both engines to
    them)."""
    free, _ = _serve_port([-1] * 6)
    eos = [-1] * 6
    eos[0] = free[0][2]
    eos[2] = free[2][1]
    return tuple(eos)


def test_tokens_transfers_and_steps_match_reference():
    eos = list(_eos_that_fires())
    want, jeng = _serve_reference(eos)
    got, teng = _serve_port(eos)
    assert got == want
    assert len(got[0]) <= 3 and got[0][-1] == eos[0]
    assert len(got[2]) <= 2 and got[2][-1] == eos[2]
    assert [len(got[i]) for i in (1, 3, 4, 5)] == [3, 4, 6, 2]
    assert teng.host_transfers == jeng.host_transfers == 2
    assert teng.steps_run == jeng.steps_run
    assert teng.generated_tokens == jeng.generated_tokens


def test_legacy_loop_gives_the_same_tokens():
    eos = list(_eos_that_fires())
    dev, _ = _serve_port(eos)
    legacy, eng = _serve_port(eos, on_device_loop=False)
    assert legacy == dev
    assert eng.host_transfers > 2             # one sync per decode step


def test_buffer_width_is_the_next_power_of_two():
    assert [ServeEngine.buffer_width(n) for n in (1, 2, 3, 5, 32, 33)] == \
        [1, 2, 4, 8, 32, 64]


@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 0.999, 1.0])
def test_percentile_matches_reference(q):
    vals = [0.3, 0.1, 0.7, 0.2, 0.9, 0.4, 0.25]
    assert percentile(vals, q) == jpercentile(vals, q)


def test_latency_stats_match_reference():
    rng = np.random.default_rng(4)
    jreqs, treqs = [], []
    for i in range(7):
        arrival, admit = rng.uniform(0, 1, size=2)
        lat = rng.uniform(0.1, 2.0)
        jreqs.append(JRequest(uid=i, prompt=None, arrival_s=arrival,
                              admit_s=admit, latency_s=lat))
        treqs.append(Request(uid=i, prompt=None, arrival_s=arrival,
                             admit_s=admit, latency_s=lat))
    assert latency_stats(treqs) == jlatency_stats(jreqs)
    assert latency_stats([]) == jlatency_stats([])


def test_engine_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA device")
    _, tm, _, tparams, _ = _setup()
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tm, tparams, capacity=CAP)


# ------------------------------------------------------------- launcher

def _launch(argv):
    from repro_torch.launch import serve as launch_serve
    return launch_serve.main(["--smoke", "--device", "cpu"] + argv)


@pytest.mark.parametrize("argv,msg", [
    (["--frontend", "--continuous"], "drop --continuous"),
    (["--frontend", "--packed", "base3"], "float weights"),
    (["--frontend", "--fidelity", "device"], "float weights"),
    (["--frontend", "--legacy-loop"], "no legacy per-step loop"),
    (["--kv", "paged"], "--continuous or --frontend"),
])
def test_launcher_refuses_what_the_reference_refuses(argv, msg, capsys):
    from repro.launch import serve as jlaunch
    for main in (_launch, lambda a: jlaunch.main(["--smoke"] + a)):
        with pytest.raises(SystemExit):
            main(argv)
        assert msg in capsys.readouterr().err


def test_launcher_frontend_prints_the_reference_keys(capsys):
    """--frontend over both front-end models: the reference's keys, top
    level and per model, and one transfer per chunk."""
    from repro.launch import serve as jlaunch
    argv = ["--frontend", "--frontend-models", "internlm2-1.8b,qwen3-14b",
            "--admission", "slo", "--requests", "4", "--prompt-len", "8",
            "--max-new", "5", "--deadline-s", "30", "--slots", "2",
            "--chunk", "2", "--capacity", "32"]
    out = _launch(argv)
    capsys.readouterr()
    jlaunch.main(["--smoke"] + argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(want)
    assert out["decode_loop"] == "frontend" and out["kv"] == "paged"
    assert out["models"] == want["models"] == ["internlm2-1.8b",
                                               "qwen3-14b"]
    assert out["admission"] == "slo" and out["queue_limit"] == 64
    assert out["host_transfers"] == out["chunks"] > 0
    assert out["completed"] == out["submitted"] == 4
    assert out["deadline_total"] == 4
    for name, row in out["capacity_report"].items():
        assert set(row) == set(want["capacity_report"][name])
        assert row["instantiated"] and row["kind"] == "paged"


def test_launcher_legacy_loop_and_backend_keep_the_tokens(monkeypatch):
    """The bucket engine's --legacy-loop and --backend torch give the
    default run's tokens; a backend the platform lacks fails loudly."""
    import repro_torch.serve as serve_pkg
    runs = []

    class Recording(serve_pkg.ServeEngine):
        def run_trace(self, *a, **kw):
            done = super().run_trace(*a, **kw)
            runs.append({r.uid: list(r.out_tokens) for r in done})
            return done

    monkeypatch.setattr(serve_pkg, "ServeEngine", Recording)
    base = ["--packed", "base3", "--requests", "3", "--prompt-len", "8",
            "--max-new", "5", "--capacity", "32"]
    outs = [_launch(base), _launch(base + ["--legacy-loop"]),
            _launch(base + ["--backend", "torch"])]
    assert runs[1] == runs[0] and runs[2] == runs[0]
    assert [o["decode_loop"] for o in outs] == ["device", "legacy", "device"]
    assert outs[0]["host_transfers"] == 1 < outs[1]["host_transfers"]
    assert outs[2]["backend"] == "torch"
    with pytest.raises(ValueError, match="platform"):
        _launch(base + ["--backend", "cuda"])
