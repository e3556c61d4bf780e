"""The port's serving front-end (``repro_torch.frontend``) on the CPU.

Two halves:

* the behaviours ``tests/test_frontend.py`` holds for the reference,
  one test each, on the port: token parity with the direct scheduler,
  two-model isolation, streaming transfer accounting and the delivery
  hook, the bounded queue and its reasons, priority over FIFO, shedding,
  FIFO never shedding, deterministic admission logs, the trace contract,
  the latency breakdown and the virtual clock (the bench-schema test
  waits for the port's benchmark);
* parity with the reference's ``repro.frontend`` on the same records,
  smoke f32 internlm2-1.8b and qwen3-14b with the reference's weights
  carried across through ``params_fn``: the prompts of
  ``trace_requests`` byte for byte, then a FIFO and an overloaded SLO
  replay under a virtual clock ticking 0.01 s a round, with equal
  per-request tokens, admission logs, replay reports (every key) and
  capacity reports.  The reference's paged pools read through their
  gather path on the CPU, the port's through the plain version of the
  fused read.

And an AST check that holds the port's front-end to the properties the
reference's lint rule RA005 holds its own to: no wall-clock call, no
unbounded ``deque``, no global RNG, no device read or sync.
"""
import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import frontend as jfrontend
from repro_torch.convert import params_from_reference
from repro_torch.frontend import (FIFOAdmission, FrontendServer,
                                  ModelRegistry, ModelSpec, SLOAdmission,
                                  VirtualClock, deadline_at, replay,
                                  replay_direct, trace_requests)
from repro_torch.serve import (Request, TraceError, latency_stats,
                               load_trace, make_trace, save_trace,
                               validate_trace)

jax.config.update("jax_platform_name", "cpu")

ARCH_A, ARCH_B = "internlm2-1.8b", "qwen3-14b"
FRONTEND = Path(__file__).resolve().parent.parent / "src" / "repro_torch" \
    / "frontend"
TICK = 0.01


def _specs():
    return [ModelSpec(name=arch, arch=arch, smoke=True, kind="paged",
                      capacity=64, slots=2, chunk=4, page_size=16)
            for arch in (ARCH_A, ARCH_B)]


@pytest.fixture(scope="module")
def registry():
    """Two smoke-model pools on the CPU, built lazily on their first
    request and shared across tests (every front-end and replay counter
    is a per-epoch delta, so a warm registry is safe to reuse)."""
    reg = ModelRegistry(device="cpu")
    for spec in _specs():
        reg.register(spec)
    return reg


def _virtual_server(reg, admission=None, queue_limit=64):
    clock = VirtualClock()
    server = FrontendServer(reg, admission, queue_limit=queue_limit,
                            clock=clock)
    return server, clock


def _replay(server, clock, records, **kw):
    return replay(server, records, sleep=clock.advance,
                  tick=lambda: clock.advance(TICK), **kw)


# ------------------------------------------------- registry

def test_registry_lazy_instantiation_and_capacity_report():
    reg = ModelRegistry(device="cpu")
    reg.register(ModelSpec(name="m", arch=ARCH_A))
    assert "m" in reg and ARCH_A not in reg
    assert not reg.is_instantiated("m")
    report = reg.capacity_report()
    assert report["m"]["instantiated"] is False
    assert "kv_bytes_pool" not in report["m"]     # no pool was built
    with pytest.raises(ValueError, match="already registered"):
        reg.register(ModelSpec(name="m", arch=ARCH_A))
    with pytest.raises(ValueError, match="kind"):
        reg.register(ModelSpec(name="x", arch=ARCH_A, kind="bucket"))
    with pytest.raises(KeyError, match="unknown model"):
        reg.spec("ghost")
    assert reg.config("m").dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ModelRegistry()                     # the card by default


# ------------------------------------------------- token parity

def test_tokens_identical_to_direct_scheduler(registry):
    trace = make_trace([0.0] * 6, [6, 8], [5, 7])
    records = trace_requests(trace, registry, [ARCH_A], seed=0)
    server, clock = _virtual_server(registry)
    rep = _replay(server, clock, records, collect_tokens=True)
    assert rep["completed"] == 6 and rep["rejected"] == 0
    fe_tokens = [rep["out_tokens"][u] for u in sorted(rep["out_tokens"])]
    _, by_uid = replay_direct(registry, records)
    dt_tokens = [by_uid[r["uid"]] for r in records]
    assert fe_tokens == dt_tokens
    for toks, rec in zip(fe_tokens, records):
        assert len(toks) == rec["max_new"]
    sched = registry.entry(ARCH_A).scheduler
    assert sched.attn_plan.backend == "paged_attn_torch"
    assert sched.cim is None


def test_two_model_isolation_interleaved(registry):
    """Interleaved traffic over both pools through ONE server: each
    model's tokens equal its own direct run."""
    trace = make_trace([0.0] * 8, [6, 8], [4, 6])
    records = trace_requests(trace, registry, [ARCH_A, ARCH_B], seed=3)
    assert {r["model"] for r in records} == {ARCH_A, ARCH_B}
    server, clock = _virtual_server(registry)
    rep = _replay(server, clock, records, collect_tokens=True)
    assert rep["completed"] == 8
    _, by_uid = replay_direct(registry, records)
    fe_tokens = [rep["out_tokens"][u] for u in sorted(rep["out_tokens"])]
    for toks, rec in zip(fe_tokens, records):
        assert toks == by_uid[rec["uid"]], rec["model"]


def test_streaming_transfer_accounting_and_hook(registry):
    """host_transfers == chunks across the drain, and the on_tokens hook
    sees every token exactly once, in order."""
    trace = make_trace([0.0] * 3, [6], [6])
    records = trace_requests(trace, registry, [ARCH_A], seed=1)
    server, clock = _virtual_server(registry)
    got = {}
    server.begin()
    streams = [server.submit(r["model"], r["prompt"],
                             max_new=r["max_new"], eos_id=r["eos_id"],
                             on_tokens=lambda s, new:
                             got.setdefault(s.uid, []).extend(new))
               for r in records]
    t0, c0 = server.host_transfers, server.chunks
    server.drain()
    assert server.host_transfers - t0 == server.chunks - c0 > 0
    for s in streams:
        assert s.status == "done" and s.finished
        assert got[s.uid] == s.tokens == list(s.req.out_tokens)
        assert s.ttft_s is not None and s.ttft_s >= 0.0


# ------------------------------------------------- backpressure

def test_bounded_queue_rejects_with_reason(registry):
    trace = make_trace([0.0] * 6, [6], [4])
    records = trace_requests(trace, registry, [ARCH_A], seed=2)
    server, clock = _virtual_server(registry, queue_limit=2)
    rep = _replay(server, clock, records)
    assert rep["max_pending_seen"] <= 2
    assert rep["submitted"] == 6
    assert rep["submitted"] == rep["completed"] + rep["rejected"]
    assert server.in_flight == 0
    assert rep["rejects_by_reason"].get("queue-full", 0) == rep["rejected"]
    assert rep["rejected"] > 0


def test_submit_rejects_unknown_model_and_over_capacity(registry):
    server, _ = _virtual_server(registry)
    s = server.submit("ghost", [1, 2, 3])
    assert s.status == "rejected" and s.reason == "unknown-model"
    s = server.submit(ARCH_A, list(range(60)), max_new=10)  # 70 > 64
    assert s.status == "rejected" and s.reason == "over-capacity"
    assert not s.accepted and s.finished
    assert server.rejects_by_reason == {"unknown-model": 1,
                                        "over-capacity": 1}
    assert server.submitted == len(server.rejected) == 2
    with pytest.raises(ValueError, match="queue_limit"):
        FrontendServer(registry, queue_limit=0)


# ------------------------------------------------- SLO admission

def test_priority_preempts_fifo_admission_order(registry):
    """Four same-arrival requests, priorities [1, 1, 0, 0], two slots: the
    SLO policy admits the urgent class first (uids 2, 3); FIFO admits in
    submission order (uids 0, 1)."""
    def first_admits(policy):
        server, clock = _virtual_server(registry, admission=policy)
        server.begin()
        for i, pri in enumerate([1, 1, 0, 0]):
            server.submit(ARCH_A, [1 + i] * 6, max_new=3, priority=pri)
        server.poll()
        admits = [e[1] for e in server.admission_log if e[0] == "admit"]
        server.drain()
        return admits[:2]

    assert first_admits(SLOAdmission()) == [2, 3]
    assert first_admits(FIFOAdmission()) == [0, 1]


def test_slo_sheds_passed_and_unmeetable_deadlines(registry):
    server, clock = _virtual_server(
        registry, admission=SLOAdmission(service_floor_s=1.0))
    server.begin()
    doomed = server.submit(ARCH_A, [1] * 6, max_new=3, deadline_s=0.05)
    tight = server.submit(ARCH_A, [2] * 6, max_new=3, deadline_s=0.5)
    free = server.submit(ARCH_A, [3] * 6, max_new=3)
    clock.advance(0.1)   # past doomed's deadline; tight needs a 1 s floor
    server.drain()
    assert doomed.status == "shed" and doomed.reason == "deadline-passed"
    assert tight.status == "shed" and tight.reason == "deadline-unmeetable"
    assert free.status == "done" and len(free.tokens) == 3
    assert server.rejects_by_reason == {"deadline-passed": 1,
                                        "deadline-unmeetable": 1}
    assert server.submitted == len(server.completed) + len(server.rejected)


def test_fifo_never_sheds_and_deadline_at():
    fifo = FIFOAdmission()
    late = Request(uid=0, prompt=[1], max_new=1, arrival_s=0.0,
                   deadline_s=0.01)
    assert fifo.shed_reason(late, now=99.0) is None
    assert deadline_at(late) == 0.01
    assert deadline_at(Request(uid=1, prompt=[1], max_new=1,
                               arrival_s=2.0)) == float("inf")
    slo = SLOAdmission()
    assert slo.shed_reason(late, now=0.005) is None
    assert slo.shed_reason(late, now=0.01) == "deadline-passed"
    late.latency_s = 0.02
    assert not late.deadline_met
    assert Request(uid=2, prompt=[1], latency_s=9.0).deadline_met


def test_admission_log_deterministic_across_replays(registry):
    """Same records, two fresh servers on one virtual timeline recipe:
    identical decision logs, tokens and shed accounting."""
    trace = make_trace([round(0.01 * i, 6) for i in range(6)],
                       [6, 8], [4, 6], priorities=[0, 1],
                       deadlines=[0.08, None])
    records = trace_requests(trace, registry, [ARCH_A], seed=5)

    def run():
        server, clock = _virtual_server(
            registry, admission=SLOAdmission(service_floor_s=0.02))
        rep = _replay(server, clock, records, collect_tokens=True)
        return server.admission_log, rep

    log1, rep1 = run()
    log2, rep2 = run()
    assert log1 == log2
    assert rep1["out_tokens"] == rep2["out_tokens"]
    assert rep1["shed"] == rep2["shed"]
    assert rep1["deadline_met"] == rep2["deadline_met"]


# ------------------------------------------------- trace contract

def test_trace_roundtrip_and_canonicalization(tmp_path):
    trace = make_trace([0.0, 0.5], [8], [4], priorities=[0, 1],
                       deadlines=[None, 0.25])
    path = os.path.join(tmp_path, "t.json")
    save_trace(path, trace)
    assert load_trace(path) == validate_trace(trace) == trace
    got = validate_trace([{"arrival_s": 0, "prompt_len": 4, "max_new": 2}])
    assert got == [{"arrival_s": 0.0, "prompt_len": 4, "max_new": 2,
                    "eos_id": -1, "priority": 0, "deadline_s": None}]


@pytest.mark.parametrize("bad,msg", [
    ({"not": "a list"}, "expected a JSON list"),
    ([[1, 2]], "expected an object"),
    ([{"arrival_s": 0.0}], "missing required keys"),
    ([{"arrival_s": -1, "prompt_len": 4, "max_new": 2}],
     "negative arrival_s"),
    ([{"arrival_s": 1.0, "prompt_len": 4, "max_new": 2},
      {"arrival_s": 0.5, "prompt_len": 4, "max_new": 2}],
     "sorted by arrival"),
    ([{"arrival_s": 0, "prompt_len": 0, "max_new": 2}], "prompt_len"),
    ([{"arrival_s": 0, "prompt_len": 4, "max_new": 0}], "max_new"),
    ([{"arrival_s": 0, "prompt_len": 4, "max_new": 2,
       "deadline_s": -0.5}], "deadline_s must be positive"),
    ([{"arrival_s": "soon", "prompt_len": 4, "max_new": 2}],
     "non-numeric"),
])
def test_trace_validation_errors(bad, msg):
    with pytest.raises(TraceError, match=msg):
        validate_trace(bad)


def test_load_trace_malformed_json(tmp_path):
    path = os.path.join(tmp_path, "bad.json")
    with open(path, "w") as f:
        f.write("{nope")
    with pytest.raises(TraceError, match="unparseable JSON"):
        load_trace(path)


# ------------------------------------------------- latency breakdown

def test_latency_stats_p999_and_queue_service_split():
    reqs = [Request(uid=0, prompt=[1], max_new=1, arrival_s=0.0,
                    latency_s=1.0, admit_s=0.3),
            Request(uid=1, prompt=[1], max_new=1, arrival_s=1.0,
                    latency_s=0.5, admit_s=0.8)]   # admit before arrival
    st = latency_stats(reqs)
    assert st["mean_s"] == 0.75
    # uid 0 waited 0.3 then decoded 0.7; uid 1's wait clamps to 0
    assert st["queue_wait_mean_s"] == 0.15
    assert st["service_mean_s"] == 0.6
    assert st["p50_s"] <= st["p99_s"] <= st["p999_s"] <= 1.0
    zero = latency_stats([])
    assert zero["p999_s"] == 0.0 and zero["queue_wait_mean_s"] == 0.0
    many = [Request(uid=i, prompt=[1], max_new=1,
                    latency_s=float(i) / 1000.0, admit_s=0.0)
            for i in range(1001)]
    st = latency_stats(many)
    assert st["p99_s"] < st["p999_s"] < 1.0   # interpolated, not max


def test_virtual_clock():
    clock = VirtualClock()
    assert clock() == 0.0
    clock.advance(0.5)
    clock.sleep(0.25)
    clock.advance(-1.0)        # clamps: time never goes backwards
    assert clock() == 0.75


# ------------------------------------------------- against the reference

@pytest.fixture(scope="module")
def pair():
    """The reference's registry and the port's, the same specs; the
    port's weights are the reference's, carried across on first use."""
    jreg = jfrontend.ModelRegistry()
    for spec in _specs():
        jreg.register(jfrontend.ModelSpec(**{
            f: getattr(spec, f) for f in spec.__dataclass_fields__}))

    def params_fn(spec, cfg, model):
        tree = jax.tree.map(np.asarray, jreg.entry(spec.name).params)
        return params_from_reference(tree, device="cpu")

    treg = ModelRegistry(device="cpu", params_fn=params_fn)
    for spec in _specs():
        treg.register(spec)
    return jreg, treg


def test_trace_requests_prompts_equal_the_reference(pair):
    jreg, treg = pair
    trace = make_trace([0.0, 0.1, 0.3, 0.3, 0.7], [5, 9, 12], [3, 4])
    for seed in (0, 7):
        want = jfrontend.trace_requests(trace, jreg, [ARCH_A, ARCH_B],
                                        seed=seed)
        got = trace_requests(trace, treg, [ARCH_A, ARCH_B], seed=seed)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g["prompt"].dtype == w["prompt"].dtype == np.int32
            assert g["prompt"].tobytes() == w["prompt"].tobytes()
            assert {k: v for k, v in g.items() if k != "prompt"} == \
                {k: v for k, v in w.items() if k != "prompt"}
    assert not treg.is_instantiated(ARCH_A)    # configs only, no weights


SCENARIOS = {
    # interleaved traffic over both models, FIFO, no pressure
    "fifo": dict(trace=dict(arrivals=[0.0] * 6, prompt_lens=[6, 9],
                            max_news=[5, 3]),
                 admission=lambda mod: mod.FIFOAdmission(), queue_limit=64),
    # overload: two classes, tight deadlines, a short queue, shedding
    "slo": dict(trace=dict(arrivals=[0.0] * 6 + [0.01] * 6,
                           prompt_lens=[6, 8, 5], max_news=[12, 16],
                           priorities=[0, 1], deadlines=[0.05, None]),
                admission=lambda mod: mod.SLOAdmission(service_floor_s=0.03),
                queue_limit=4),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replay_matches_the_reference(pair, name):
    """The same records through the reference's server and the port's,
    each under a virtual clock ticking TICK a round: equal tokens,
    admission logs, replay reports and capacity reports."""
    import repro.frontend as jmod
    import repro_torch.frontend as tmod
    jreg, treg = pair
    sc = SCENARIOS[name]
    t = sc["trace"]
    trace = make_trace(t["arrivals"], t["prompt_lens"], t["max_news"],
                       priorities=t.get("priorities"),
                       deadlines=t.get("deadlines"))
    records = trace_requests(trace, treg, [ARCH_A, ARCH_B], seed=11)
    out = {}
    for mod, reg in ((jmod, jreg), (tmod, treg)):
        clock = mod.VirtualClock()
        server = mod.FrontendServer(reg, sc["admission"](mod),
                                    queue_limit=sc["queue_limit"],
                                    clock=clock)
        rep = mod.replay(server, records, sleep=clock.advance,
                         tick=lambda clock=clock: clock.advance(TICK),
                         collect_tokens=True)
        out[mod.__name__] = (rep, server.admission_log)
    (jrep, jlog), (trep, tlog) = out["repro.frontend"], \
        out["repro_torch.frontend"]
    assert tlog == jlog
    assert trep["out_tokens"] == jrep["out_tokens"]
    assert set(trep) == set(jrep)
    assert {k: v for k, v in trep.items() if k != "out_tokens"} == \
        {k: v for k, v in jrep.items() if k != "out_tokens"}
    assert trep["host_transfers"] == trep["chunks"] > 0
    if name == "slo":
        assert trep["shed"] > 0
        assert trep["rejects_by_reason"]["queue-full"] > 0
    assert json.loads(json.dumps(treg.capacity_report())) == \
        json.loads(json.dumps(jreg.capacity_report()))


# ------------------------------------------------- source properties

WALLCLOCK = {"time", "monotonic", "perf_counter", "time_ns",
             "monotonic_ns", "perf_counter_ns"}
GLOBAL_RNG = {"rand", "randn", "randint", "random", "random_sample",
              "choice", "shuffle", "permutation", "uniform", "normal",
              "standard_normal", "seed", "manual_seed", "randperm",
              "randn_like", "rand_like", "randint_like", "choices",
              "randrange", "sample", "gauss"}
DEVICE_READS = {"cpu", "item", "tolist", "synchronize"}


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def frontend_findings(source: str) -> list:
    """What the reference's RA005 bans in its front-end, and the device
    reads the port's contract bans: wall-clock CALLS (passing the
    function as a default is fine), ``deque()`` without ``maxlen``,
    global RNG draws (``random.*``, ``np.random.*`` but
    ``default_rng(seed)``, ``torch.rand*``), and ``.cpu()`` /
    ``.item()`` / ``.tolist()`` / ``torch.cuda.synchronize()``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        head, _, last = name.rpartition(".")
        if head == "time" and last in WALLCLOCK:
            out.append(f"{node.lineno}: wall-clock call {name}()")
        if last == "deque" and not any(k.arg == "maxlen"
                                       for k in node.keywords) \
                and len(node.args) < 2:
            out.append(f"{node.lineno}: deque() without maxlen")
        if (head in ("random", "np.random", "numpy.random", "torch")
                and last in GLOBAL_RNG):
            out.append(f"{node.lineno}: global RNG {name}()")
        if head in ("np.random", "numpy.random") and \
                last == "default_rng" and not node.args:
            out.append(f"{node.lineno}: unseeded {name}()")
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in DEVICE_READS:
            out.append(f"{node.lineno}: device read .{node.func.attr}()")
    return out


def test_frontend_source_is_deterministic_bounded_and_sync_free():
    files = sorted(FRONTEND.glob("*.py"))
    assert {f.name for f in files} >= {"admission.py", "registry.py",
                                       "server.py", "loadgen.py"}
    findings = {f.name: frontend_findings(f.read_text()) for f in files}
    assert findings == {f.name: [] for f in files}
    # the check itself flags what it is meant to flag
    bad = ("import time, random, collections\nimport numpy as np\n"
           "def f(x, clock=time.monotonic):\n"
           "    t = time.perf_counter()\n"
           "    q = collections.deque()\n"
           "    r = random.random() + np.random.rand()\n"
           "    g = np.random.default_rng()\n"
           "    torch.cuda.synchronize()\n"
           "    return x.cpu(), x.item(), x.tolist()\n")
    assert len(frontend_findings(bad)) == 9
    assert frontend_findings(
        "import collections\nq = collections.deque(maxlen=4)\n"
        "import numpy as np\ng = np.random.default_rng(3)\n") == []
