"""The port's analysis passes (``repro_torch.analysis``) on the CPU: the
capability and sanitize cases of ``tests/test_analysis.py`` that have a
torch meaning, the ``blockmap`` and ``frontend`` passes, every
``--inject-*`` self-test of the CLI exiting nonzero and naming its rule,
and parity with the reference's ``repro.analysis``:

  * the same requests, drawn from one numpy seed, give the same
    ``transfers`` and ``chunks_run`` under both packages' ``sanitize``,
    on ``Scheduler`` and ``PagedScheduler``;
  * every (op, domain, packing, kv_layout, fidelity) request the
    reference's ``auto`` resolves on the CPU also resolves in the port,
    on ``cpu`` and on ``cuda``.
"""
import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as ref_configs
from repro.analysis import sanitize as ref_sanitize
from repro.kernels import plan as ref_plan
from repro.models import registry as ref_registry
from repro.serve import PagedScheduler as RefPaged
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro_torch.analysis import (PASSES, SanitizeError, blockmap,
                                  capability, frontend, sanitize, sanitizer)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels import plan_matmul
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")


# ------------------------------------------------------- clean passes

def test_capability_pass_clean():
    assert capability.run() == []


def test_blockmap_pass_clean():
    assert blockmap.run() == []


def test_frontend_pass_clean():
    assert frontend.run(device="cpu") == []


def test_the_cli_runs_every_pass_clean(capsys):
    assert cli_main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name, _ in PASSES:
        assert f"[{name}] 0 finding(s)" in out
    assert "OK: all passes clean" in out


# -------------------------------------------------- capability drift

def test_capability_matrix_round_trips():
    parsed = capability.parse_capability_matrix(
        capability.render_capability_matrix())
    assert set(parsed) == set(capability._registry())


def test_capability_readme_drift_is_flagged(tmp_path):
    text = capability.render_capability_matrix()
    doctored = text.replace("cpu, cuda", "cpu", 1)
    assert doctored != text
    readme = tmp_path / "README.md"
    readme.write_text("# doctored\n\n" + doctored)
    findings = capability.check_readme_matrix(capability._registry(),
                                              str(readme))
    assert findings and all(f.rule == "CAP006" for f in findings)


def test_capability_readme_missing_backend_is_flagged(tmp_path):
    kept = [ln for ln in capability.render_capability_matrix().splitlines()
            if "`ref`" not in ln]
    readme = tmp_path / "README.md"
    readme.write_text("# doctored\n\n" + "\n".join(kept) + "\n")
    findings = capability.check_readme_matrix(capability._registry(),
                                              str(readme))
    assert any("ref" in f.message for f in findings)


def test_cli_capability_drift_exits_nonzero(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("# no matrix here\n")
    assert cli_main(["--passes", "capability", "--readme",
                     str(readme)]) != 0


def test_capability_executes_every_declared_cpu_cell(monkeypatch):
    """Each declared cpu cell, and each abstract one (on meta tensors),
    runs once through ``execute`` (and the trit2 refusal once more); no
    cuda cell runs without a card."""
    import repro_torch.kernels as kernels
    ran = []
    orig = kernels.execute

    def counted(plan, x, w):
        ran.append((plan.op, plan.backend, plan.platform))
        return orig(plan, x, w)
    monkeypatch.setattr(kernels, "execute", counted)
    assert capability.run(run_cuda=False) == []
    declared = sum(
        s.supports(op, d, p, platform, kv, f)
        for s in capability._registry().values()
        for op, d, p, kv, f, platform in itertools.product(
            plan_mod.OPS, plan_mod.DOMAINS, plan_mod.PACKINGS,
            plan_mod.KV_LAYOUTS, plan_mod.FIDELITIES, ("cpu", "abstract")))
    assert len(ran) == declared + 1
    assert all(platform in ("cpu", "abstract") for _, _, platform in ran)


def test_capability_flags_an_unregistered_capability(monkeypatch):
    """A registry that declares more than resolution grants (the cuda
    backend on the CPU) is flagged (CAP001), and the matrix no longer
    matches it (CAP006)."""
    reg = capability._registry()
    bad = dataclasses.replace(reg["cuda"],
                              platforms=frozenset({"cpu", "cuda"}))
    reg["cuda"] = bad
    rules = {f.rule for f in capability.run(registry=reg, run_cuda=False)}
    assert {"CAP001", "CAP006"} <= rules


# ------------------------------------------------- blockmap violations

def test_blockmap_pinned_bad_blocks_flagged():
    rules = {f.rule for f in blockmap.run(pin_blocks=(100, 3, 100))}
    assert "BM001" in rules and "BM002" in rules


def test_cli_blockmap_pinned_exits_nonzero():
    assert cli_main(["--passes", "blockmap", "--pin-blocks",
                     "100,100,100"]) != 0


def test_blockmap_rule_plans_clean():
    for route, domain, plan in blockmap.route_plans(333, 77, 129, "trit2",
                                                    132):
        assert blockmap.check_plan(route, 333, 77, 129, "trit2", domain,
                                   plan, 132) == []
    assert blockmap.check_plan("mma", 1024, 28672, 8192, "trit2", "float",
                               (256, 4, 7168)) == []
    assert [f.rule for f in blockmap.check_plan(
        "mma", 1024, 28672, 8192, "trit2", "float", (256, 2, 14336))] == \
        ["BM003"]


# ------------------------------------------------------ sanitize: unit

def _dummy():
    return types.SimpleNamespace(host_transfers=0)


def test_sanitize_counts_transfers_and_restores():
    orig = engine._EngineBase._device_get
    with sanitize() as rep:
        engine._EngineBase._device_get(_dummy(), torch.ones(3))
        engine._EngineBase._device_get(_dummy(), torch.zeros(2))
    assert rep.transfers == 2
    assert engine._EngineBase._device_get is orig
    assert not rep.sync_guard                  # no card: no guard


def test_sanitize_transfer_budget_enforced():
    with pytest.raises(SanitizeError, match="budget is 0"):
        with sanitize(max_transfers=0):
            engine._EngineBase._device_get(_dummy(), torch.ones(3))


def test_sanitize_counts_new_plans():
    with sanitize() as rep:
        plan_matmul((3, 257, 11), platform="cpu")     # a fresh key
    assert rep.new_plans >= 1 and rep.builds == 0
    with pytest.raises(SanitizeError, match="new plans"):
        with sanitize(max_new_plans=0):
            plan_matmul((3, 259, 11), platform="cpu")


def test_sanitize_clean_region_counts_nothing():
    plan_matmul((5, 64, 7), platform="cpu")           # warm-up
    with sanitize(max_transfers=0, max_new_plans=0, max_builds=0) as rep:
        plan_matmul((5, 64, 7), platform="cpu")       # a cache hit
    assert rep.transfers == rep.new_plans == rep.builds == 0


# ------------------------------------------------------ sanitize: serve

@pytest.fixture(scope="module")
def smoke():
    return sanitizer.smoke_model("cpu")


@pytest.mark.parametrize("kind", sanitizer.ENGINES)
def test_engine_one_transfer_per_chunk_no_new_plan(smoke, kind):
    """The accounting as enforced invariants: the measured region makes
    exactly chunks_run transfers (one per bucket for the bucket engine;
    the engine's own counter agrees) and resolves no new plan."""
    cfg, model, params, cim = smoke
    eng = sanitizer.make_engine(kind, model, params, cim, "cpu")
    for r in sanitizer.smoke_requests(cfg.vocab_size, range(3)):
        eng.submit(r)
    eng.run()
    chunks0 = getattr(eng, "chunks_run", 0)
    transfers0 = eng.host_transfers
    with sanitize() as rep:
        for r in sanitizer.smoke_requests(cfg.vocab_size, range(10, 13)):
            eng.submit(r)
        eng.run()
    chunks = (eng.chunks_run - chunks0 if kind != "bucket" else 1)
    assert chunks > 0
    assert rep.transfers == chunks == eng.host_transfers - transfers0
    assert rep.new_plans == 0 and rep.builds == 0


def test_sanitize_pass_catches_injected_violations():
    findings = sanitizer.run(inject=("transfer", "replan"), device="cpu",
                             engines=("dense",))
    rules = {f.rule for f in findings}
    assert rules == {"SAN001", "SAN002"}


@pytest.mark.parametrize("flag, value, rule", [
    ("--inject-capability", "drift", "CAP006"),
    ("--inject-capability", "missing", "CAP006"),
    ("--inject-blockmap", "tile", "BM001"),
    ("--inject-blockmap", "coverage", "BM002"),
    ("--inject-blockmap", "chain", "BM003"),
    ("--inject-autotune", "structure", "AT001"),
    ("--inject-autotune", "invariant", "AT002"),
    ("--inject-autotune", "duplicate", "AT003"),
    ("--inject-autotune", "coverage", "AT004"),
    ("--inject-autotune", "canonical", "AT005"),
    ("--inject-sanitize", "transfer", "SAN001"),
    ("--inject-sanitize", "replan", "SAN002"),
    ("--inject-frontend", "transfer", "FE001"),
    ("--inject-frontend", "drop", "FE002"),
    ("--inject-frontend", "order", "FE003"),
])
def test_cli_injection_exits_nonzero_naming_its_rule(capsys, flag, value,
                                                     rule):
    pass_name = flag.split("-")[-1]
    assert cli_main(["--passes", pass_name, "--device", "cpu", flag,
                     value]) != 0
    assert f":{rule}]" in capsys.readouterr().out


# ------------------------------------------- parity with the reference

def _ref_sanitized_counts(kind):
    cfg = dataclasses.replace(ref_configs.smoke("internlm2-1.8b"),
                              dtype=jnp.float32)
    model = ref_registry.build(cfg)
    params = model.init(jax.random.key(0))
    if kind == "paged":
        sched = RefPaged(model, params, capacity=64, slots=2, chunk=4,
                         page_size=16)
    else:
        sched = RefScheduler(model, params, capacity=64, slots=2, chunk=4)
    for r in sanitizer.smoke_requests(cfg.vocab_size, range(3)):
        sched.submit(RefRequest(uid=r.uid, prompt=jnp.asarray(r.prompt),
                                max_new=r.max_new))
    sched.run()
    chunks0 = sched.chunks_run
    with ref_sanitize() as rep:
        for r in sanitizer.smoke_requests(cfg.vocab_size, range(10, 13)):
            sched.submit(RefRequest(uid=r.uid, prompt=jnp.asarray(r.prompt),
                                    max_new=r.max_new))
        sched.run()
    return rep.transfers, sched.chunks_run - chunks0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sanitize_counts_match_the_reference(smoke, kind):
    cfg, model, params, cim = smoke
    eng = sanitizer.make_engine("dense" if kind == "dense" else "gather",
                                model, params, cim, "cpu")
    for r in sanitizer.smoke_requests(cfg.vocab_size, range(3)):
        eng.submit(r)
    eng.run()
    chunks0 = eng.chunks_run
    with sanitize() as rep:
        for r in sanitizer.smoke_requests(cfg.vocab_size, range(10, 13)):
            eng.submit(r)
        eng.run()
    got = (rep.transfers, eng.chunks_run - chunks0)
    assert got == _ref_sanitized_counts(kind)
    assert got[0] == got[1] > 0


def test_every_request_the_reference_resolves_resolves_here():
    ref_plan._ensure_builtin_backends()
    resolved = 0
    for op, d, p, kv, f in itertools.product(
            ref_plan.OPS, ref_plan.DOMAINS, ref_plan.PACKINGS,
            ref_plan.KV_LAYOUTS, ref_plan.FIDELITIES):
        try:
            ref_plan.resolve_backend(op, "auto", d, p, "cpu", kv, f)
        except ValueError:
            continue
        resolved += 1
        for platform in ("cpu", "cuda"):
            plan_mod.resolve_backend(op, "auto", d, p, platform, kv, f)
    assert resolved > 0
