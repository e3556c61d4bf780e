"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``) on the CPU:

  * ``model_flops`` and the configs' ``param_count`` /
    ``active_param_count`` equal the reference's for every arch and kind;
  * the wire bytes of each collective kind at group sizes 2, 4 and 16
    equal the reference's ``collective_bytes`` on matching HLO lines;
  * the roll-up (``op_cost.OpCost``) counts 2·M·K·N for one product,
    12x for a loop of 12 and 15x for loops of 3 inside 5 (a Python loop
    unrolls by itself: the counterpart of the reference's trip counts);
  * the matmul FLOPs one rank of the port's smoke internlm2-1.8b train,
    prefill and decode cells dispatches on a data-only fake mesh (4, 1)
    equal the reference's dot FLOPs on its compiled step on a 4-device
    jax mesh within 2% (train: after the reference's attention backward,
    which recomputes each QK^T product once more); on (2, 2) the port's
    are the model axis's 2x of its (4, 1) ones (its ranks along
    ``model`` repeat each other's compute), and so 2x the reference's.

The reference compiles in a subprocess with 4 host devices, the port
traces in another (a fake process group lives for one process); the two
run at once.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_threads import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dryrun_worker.py")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = ("4x1", "2x2")


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(HERE, "..", "src"), **extra)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def flops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flops")
    cells = [[f"{m}|{s}", "internlm2-1.8b", s,
              {"smoke": True, "mesh_shape": [int(d) for d in m.split("x")],
               "microbatches": 8}]
             for m in MESHES for s in SHAPES]
    ref = subprocess.Popen(
        [sys.executable, WORKER, "ref-flops", str(tmp / "ref.json"),
         ",".join(MESHES)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run(
        [sys.executable, WORKER, "port-cells", str(tmp / "port.json"),
         json.dumps(cells)], env=_env(), capture_output=True, text=True,
        timeout=600)
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    with open(tmp / "ref.json") as f:
        ref_flops = json.load(f)
    with open(tmp / "port.json") as f:
        reports = json.load(f)
    return ref_flops, reports


def _matmul(report) -> int:
    assert "error" not in report, report
    products = report["collectives"]["products"]
    assert products["unplaced"] == 0
    return products["bf16"] + products["f32"]


def _qk_recompute(mesh: str) -> float:
    """The reference's flash backward recomputes QK^T once per layer:
    2·rows·heads·S²·hd over one device's rows and heads of the train
    cell (its heads split over ``model``)."""
    from repro_torch import configs
    cfg = configs.smoke("internlm2-1.8b")
    data, model = (int(d) for d in mesh.split("x"))
    return (2.0 * (256 // data) * (cfg.num_heads // model) * 4096 ** 2
            * cfg.hd * cfg.num_layers)


@pytest.mark.parametrize("shape", SHAPES)
def test_data_mesh_matmul_flops_match_reference(flops, shape):
    ref, port = flops
    want = ref[f"4x1|{shape}"]
    if shape == "train_4k":
        want -= _qk_recompute("4x1")
    got = _matmul(port[f"4x1|{shape}"])
    assert got == pytest.approx(want, rel=0.02), (got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_model_axis_repeats_compute(flops, shape):
    ref, port = flops
    one, two = _matmul(port[f"4x1|{shape}"]), _matmul(port[f"2x2|{shape}"])
    assert two == 2 * one
    want = ref[f"2x2|{shape}"]
    if shape == "train_4k":
        want -= _qk_recompute("2x2")
    assert two / want == pytest.approx(2.0, rel=0.02)


def test_param_counts_equal_reference():
    import repro.configs as rc
    from repro_torch import configs
    for arch in configs.ARCHS:
        ours, theirs = configs.get(arch), rc.get(arch)
        assert ours.param_count() == theirs.param_count(), arch
        assert ours.active_param_count() == theirs.active_param_count(), \
            arch


def test_model_flops_equal_reference():
    import repro.configs as rc
    from repro.roofline import model_flops as ref_model_flops
    from repro_torch import configs
    from repro_torch.roofline import model_flops
    for arch in configs.ARCHS:
        for kind in ("train", "serve"):
            assert model_flops(configs.get(arch), 4096, kind) == \
                ref_model_flops(rc.get(arch), 4096, kind), (arch, kind)


HLO_KIND = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
            "collective-permute": "collective-permute"}


@pytest.mark.parametrize("group", (2, 4, 16))
@pytest.mark.parametrize("kind", sorted(HLO_KIND))
def test_wire_bytes_equal_reference(kind, group):
    from repro.roofline import collective_bytes as ref_bytes
    from repro_torch.roofline import collective_bytes
    total = 32
    shape = "bf16[48,64]" if kind != "reduce-scatter" else "f32[8,64]"
    size = 48 * 64 * 2 if kind != "reduce-scatter" else 8 * 64 * 4
    groups = ("" if kind == "collective-permute" else
              f", replica_groups=[{total // group},{group}]<=[{total}]")
    line = f"  %c = {shape}{{1,0}} {HLO_KIND[kind]}(%p0), channel_id=1" \
           f"{groups}"
    want = ref_bytes(line, total)
    got = collective_bytes([(kind, size,
                             total if kind == "collective-permute"
                             else group)])
    assert got[kind] == pytest.approx(want[kind])
    assert got["total"] == pytest.approx(want["total"])
    assert got["counts"] == want["counts"]


def _square(n=128):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(n, n, generator=g).bfloat16(),
            torch.randn(n, n, generator=g).bfloat16())


def test_one_product():
    """Outside the model code a product is placed by its dtype, and
    counted as unplaced too (as ``chip_smoke.py``'s ``step_ops``)."""
    from repro_torch.roofline import OpCost
    x, w = torch.randn(64, 96), torch.randn(96, 40)
    with OpCost() as cost:
        x @ w
    n = 2 * 64 * 96 * 40
    assert cost.products == {"bf16": 0, "f32": n, "unplaced": n}
    assert cost.bytes == 4 * (64 * 96 + 96 * 40 + 64 * 40)


def test_loop_multiplies_by_trip_count():
    from repro_torch.roofline import OpCost
    x, w = _square()
    with OpCost() as cost:
        for _ in range(12):
            x = x @ w
    assert cost.products["bf16"] == 12 * 2 * 128 ** 3


def test_nested_loops():
    from repro_torch.roofline import OpCost
    x, w = _square()
    with OpCost() as cost:
        for _ in range(5):
            for _ in range(3):
                x = x @ w
    assert cost.products["bf16"] == 15 * 2 * 128 ** 3


def test_live_bytes_peak_and_categories():
    from repro_torch.roofline import OpCost
    w = torch.randn(256, 256)
    with OpCost() as cost:
        cost.register({"w": w}, "params")
        y = torch.tanh(torch.randn(256, 256) @ w)
        del y
        z = torch.ones(1024)
    stats = cost.memory_stats()
    # w, the draw, the product and its tanh: the draw and the product
    # die with their last use, three 256 KiB buffers at most at once
    assert stats["peak_bytes"] == 3 * 256 * 256 * 4
    assert stats["peak_by_category"]["params"] == 256 * 256 * 4
    assert z.numel() == 1024


def test_analyze_step_report():
    from repro_torch import configs
    from repro_torch.roofline import H100, OpCost, analyze_step
    x, w = _square()
    with OpCost() as cost:
        x @ w
    cfg = configs.smoke("internlm2-1.8b")
    r = analyze_step(cost, arch="t", shape="s", mesh_name="1", chips=1,
                     cfg=cfg, tokens=1024, kind="train")
    assert r.bottleneck in ("compute", "memory", "collective")
    assert r.t_compute == pytest.approx(2 * 128 ** 3 / H100.peak_flops)
    assert r.t_memory == pytest.approx(3 * 128 * 128 * 2 / H100.hbm_bw)
    assert r.model_flops_total == pytest.approx(6 * cfg.param_count() * 1024)
    assert set(r.to_dict()) >= {"flops_per_device", "bytes_per_device",
                                "wire_bytes_per_device", "bottleneck",
                                "useful_ratio", "peak_fraction",
                                "collectives", "memory_stats"}
    assert "|" in r.row()


def test_indexed_read_and_write_count_their_slices():
    """An indexed read counts twice its result, an indexed write twice
    its values (with the indices), not the whole buffer."""
    from repro_torch.roofline import OpCost
    table = torch.zeros(4096, 64)
    idx = torch.tensor([1, 5, 9])
    vals = torch.ones(3, 64)
    with OpCost() as cost:
        table[idx]
    assert cost.bytes == 2 * 3 * 64 * 4 + 3 * 8
    with OpCost() as cost:
        table[idx] = vals
    assert cost.bytes == 2 * 3 * 64 * 4 + 3 * 8
