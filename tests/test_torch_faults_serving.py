"""Device-fidelity serving of the port against the JAX reference
(``repro.faults``) on the CPU at f32 smoke size, with the same packed
weights (carried across by ``repro_torch.convert``) and the same seeded
prompts (numpy); the rest of the fault campaigns' parity is in
``tests/test_torch_faults.py``.

Bars, mirroring ``tests/test_faults.py``:

  * device-fidelity ``Scheduler`` serving under ``FaultModel(seed=0,
    restore_yield=YIELDS, drift_rate=0.002)``: the reference's tokens,
    ``scrubs_run``, clip counters and served bytes, ``host_transfers ==
    chunks_run``, prefill exact; the ``PagedScheduler``, fused and
    gather, the same;
  * exact-fidelity hooks inert;
  * launcher validation and output fields.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_faults_ref import (YIELDS, packed_bytes_equal,  # noqa: F401
                               restore_campaigns, smoke_setup)
from _torch_threads import one_thread  # noqa: F401
from repro import faults as jfaults
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.serve import PagedScheduler as JPagedScheduler
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import faults
from repro_torch.core import error_injection as ei
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import PagedScheduler, Request, Scheduler


# ------------------------------------------------- serving integration

def _prompts(count=2, length=8, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=length).astype(np.int32)
            for _ in range(count)]


FAULTS = dict(seed=0, restore_yield=YIELDS, drift_rate=0.002)


def _serve_port(cls, tm, tparams, faults_kw=FAULTS, **kw):
    faults.set_fault_model(faults.FaultModel(**faults_kw))
    cim = CIMConfig(mode="ternary", packing="base3", fidelity="device")
    s = cls(tm, tparams, capacity=64, slots=2, chunk=2, cim=cim,
            scrub_every=2, device="cpu", **kw)
    for i, p in enumerate(_prompts()):
        s.submit(Request(uid=i, prompt=p, max_new=4))
    return s, {r.uid: r.out_tokens for r in s.run()}


def test_device_serving_matches_the_reference():
    _, jm, tm, jparams, tparams = smoke_setup()
    jfaults.set_fault_model(jfaults.FaultModel(**FAULTS))
    js = JScheduler(jm, jparams, capacity=64, slots=2, chunk=2,
                    cim=JCIMConfig(mode="ternary", packing="base3",
                                   fidelity="device"), scrub_every=2)
    for i, p in enumerate(_prompts()):
        js.submit(JRequest(uid=i, prompt=jnp.asarray(p), max_new=4))
    want = {r.uid: r.out_tokens for r in js.run()}
    s, got = _serve_port(Scheduler, tm, tparams)
    assert got == want
    assert all(len(t) == 4 for t in got.values())
    assert s.cim.backend == "device" and s.cim.fidelity == "device"
    assert s.cim_prefill.fidelity == "exact"
    assert s.cim_prefill.backend == "torch"
    assert s.host_transfers == s.chunks_run == js.chunks_run
    assert s.scrubs_run == js.scrubs_run >= 1
    assert (s.adc_clip_lo, s.adc_clip_hi) == (js.adc_clip_lo,
                                              js.adc_clip_hi)
    assert packed_bytes_equal(js.params, s.params)
    err = faults.packed_trit_error_rate(s.params, s._params_pristine)
    bound = ei.expected_trit_error_rate(YIELDS, (1 / 3, 1 / 3, 1 / 3))
    assert 0.0 < err <= 3.0 * bound
    assert s.decode_per_slot


@pytest.mark.parametrize("fused", [True, False])
def test_device_paged_serving_matches_the_reference(fused):
    """The reference's fused read is one device-MAC call over every slot
    (one input scale, one ADC-noise draw); its gather read vmaps a
    one-slot decode.  The port's PagedScheduler must follow each."""
    _, jm, tm, jparams, tparams = smoke_setup()
    fm = dict(FAULTS, adc_noise_sigma=0.5)
    jfaults.set_fault_model(jfaults.FaultModel(**fm))
    js = JPagedScheduler(jm, jparams, capacity=64, slots=2, chunk=2,
                         page_size=4, cim=JCIMConfig(
                             mode="ternary", packing="base3",
                             fidelity="device"),
                         scrub_every=2, fused_attn=fused)
    assert (js.attn_plan is not None) == fused
    for i, p in enumerate(_prompts()):
        js.submit(JRequest(uid=i, prompt=jnp.asarray(p), max_new=4))
    want = {r.uid: r.out_tokens for r in js.run()}
    ps, got = _serve_port(PagedScheduler, tm, tparams, faults_kw=fm,
                          page_size=4, fused_attn=fused)
    assert (ps.attn_plan is not None) == fused
    assert ps.decode_per_slot == (not fused)
    assert got == want
    assert ps.host_transfers == ps.chunks_run == js.chunks_run
    assert ps.scrubs_run == js.scrubs_run >= 1
    assert (ps.adc_clip_lo, ps.adc_clip_hi) == (js.adc_clip_lo,
                                                js.adc_clip_hi)
    assert packed_bytes_equal(js.params, ps.params)


def test_exact_serving_hooks_inert():
    _, _, tm, _, tparams = smoke_setup()
    cim = CIMConfig(mode="ternary", packing="base3")
    assert cim.resolve("cpu") == cim.resolve("cpu", phase="prefill")
    runs = []
    for _ in range(2):
        s = Scheduler(tm, tparams, capacity=64, slots=2, chunk=4, cim=cim,
                      device="cpu")
        for i, p in enumerate(_prompts(3)):
            s.submit(Request(uid=i, prompt=p, max_new=6))
        runs.append({r.uid: r.out_tokens for r in s.run()})
        assert s._fault_serving is False
        assert s._round_extras() == ()
        assert s.adc_clip_lo == s.adc_clip_hi == s.scrubs_run == 0
        assert s.host_transfers == s.chunks_run
        assert s.params is tparams
    assert runs[0] == runs[1]


# --------------------------------------------------------- launcher

def test_launcher_validation_and_fields(capsys):
    for argv, msg in ((["--fidelity", "device", "--continuous"], "--packed"),
                      (["--fidelity", "device", "--packed", "base3"],
                       "--continuous")):
        with pytest.raises(SystemExit):
            launch_serve.main(["--smoke", "--device", "cpu"] + argv)
        assert msg in capsys.readouterr().err
    out = launch_serve.main([
        "--smoke", "--device", "cpu", "--packed", "base3", "--continuous",
        "--slots", "2", "--chunk", "2", "--capacity", "32", "--requests",
        "3", "--prompt-len", "8", "--max-new", "5", "--fidelity", "device",
        "--scrub-every", "2"])
    assert out["fidelity"] == "device" and out["backend"] == "device"
    assert out["scrubs"] >= 1 and out["host_transfers"] == out["chunks"]
    assert {"adc_clip_lo", "adc_clip_hi"} <= set(out)
    assert faults.get_fault_model() == faults.measured_fault_model(
        seed=0, drift_rate=0.001)
    exact = launch_serve.main(["--smoke", "--device", "cpu", "--packed",
                               "base3", "--continuous", "--requests", "2",
                               "--prompt-len", "8", "--max-new", "3"])
    assert exact["fidelity"] == "exact" and "scrubs" not in exact
