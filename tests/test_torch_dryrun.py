"""The port's dry run (``repro_torch.launch.dryrun``) and its pieces on the
CPU:

  * ``configs.shapes``: ``SHAPES`` and ``runnable`` equal the
    reference's for all ten full configs;
  * ``launch.input_specs``: every leaf's shape, dtype and per-axis
    placement equal the reference's ``ShapeDtypeStruct`` /
    ``PartitionSpec`` for every arch and shape on the 16x16 mesh (the
    batch, the decode token and loop lanes, the cache, the slot and page
    pools, the params float, base3 and trit2).  The reference builds its
    specs in a subprocess with 256 host devices, the port on a fake
    process group of 256 ranks in another;
  * every arch x shape at smoke size on a fake (4, 4) mesh writes a
    report with the reference's keys or the reference's skip reason
    where ``runnable`` says so, and no cell is refused (every family
    trains on a mesh); ``--packed base3`` on one serve cell and
    ``trit2`` on another route every packed matmul to the ``abstract``
    backend; ``--opt adafactor`` on smoke internlm2-1.8b's and
    mixtral-8x7b's ``train_4k`` names the optimizer and adds its
    all-reduces.  The
    train cells run one microbatch (``--microbatches 1``) to keep the
    trace short; xlstm-125m's ``prefill_32k`` and ``train_4k`` are left
    out: its sLSTM steps through the positions one at a time, some ten
    minutes of trace each (its decode cells are in, and its train step
    at 64 positions);
  * the meshed schedulers' cells on the fake (4, 4) mesh, held to the
    reference's report and meta keys: one chunk of the ``Scheduler``
    (``--continuous 8``) and of the ``PagedScheduler`` (``--kv paged``)
    on smoke internlm2-1.8b base3, whose predicted kernel calls are
    ``chunk`` times a one-step chunk's, and ``--ep data`` on smoke
    mixtral-8x7b;
  * ``--fidelity device`` raises, naming ROADMAP queue 1 item 8, part 3;
  * the ``abstract`` backend serves fake and meta tensors only, and a
    fake tensor never reaches a kernel's launcher.
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
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ARCHS = ("internlm2-1.8b", "glm4-9b", "phi3-mini-3.8b", "qwen3-14b",
         "mixtral-8x7b", "kimi-k2-1t-a32b", "zamba2-7b", "xlstm-125m",
         "whisper-large-v3", "llama-3.2-vision-90b")
# what the sLSTM's per-position loop makes too slow to trace here (its
# train_4k, ~10 minutes at smoke size, traces at 64 positions instead:
# XLSTM_TRAIN)
LEFT_OUT = {("xlstm-125m", "prefill_32k"), ("xlstm-125m", "train_4k")}
XLSTM_TRAIN = ["train_4k", 64, 256, "train"]
PACKED = {("internlm2-1.8b", "decode_32k"): "base3",
          ("qwen3-14b", "prefill_32k"): "trit2"}
# the reference's report keys (launch/dryrun.py's run_cell)
REPORT_KEYS = {"arch", "shape", "mesh", "packed", "fsdp", "remat",
               "microbatches", "lower_s", "compile_s", "chips",
               "flops_per_device", "bytes_per_device",
               "wire_bytes_per_device", "t_compute", "t_memory",
               "t_collective", "bottleneck", "model_flops_total",
               "useful_ratio", "peak_fraction", "collectives",
               "memory_stats"}


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


# the meshed schedulers' and ep-data cells: key -> (arch, run_cell kw)
_SLOTS = dict(packed="base3", continuous=8)
MESH_CELLS = {
    "chunk8": ("internlm2-1.8b", _SLOTS),
    "chunk1": ("internlm2-1.8b", dict(_SLOTS, decode_loop=1)),
    "paged8": ("internlm2-1.8b", dict(_SLOTS, kv_layout="paged")),
    "ep-data": ("mixtral-8x7b", dict(ep="data")),
    "ep-data-chunk": ("mixtral-8x7b", dict(ep="data", continuous=8)),
}


# Adafactor's train cells, dense and MoE: key -> arch
ADAFACTOR_CELLS = {"ada-dense": "internlm2-1.8b", "ada-moe": "mixtral-8x7b"}


def _mesh_cells():
    return [[f"mesh|{key}", arch, "decode_32k",
             dict(kw, smoke=True, mesh_shape=[4, 4])]
            for key, (arch, kw) in MESH_CELLS.items()] + [
        [f"mesh|{key}", arch, "train_4k",
         dict(smoke=True, mesh_shape=[4, 4], microbatches=1,
              opt_name="adafactor")]
        for key, arch in ADAFACTOR_CELLS.items()] + [
        ["mesh|xlstm-train", "xlstm-125m", XLSTM_TRAIN,
         dict(smoke=True, mesh_shape=[4, 4], microbatches=1)]]


def _cells():
    out = []
    for arch in ARCHS:
        for shape in SHAPE_NAMES:
            if (arch, shape) in LEFT_OUT:
                continue
            kw = {"smoke": True, "mesh_shape": [4, 4], "microbatches": 1}
            if (arch, shape) in PACKED:
                kw["packed"] = PACKED[(arch, shape)]
            out.append([f"{arch}|{shape}", arch, shape, kw])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's specs, and the port's smoke cells
    in two halves: four subprocesses at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, WORKER, "ref-specs", str(tmp / "ref.json")],
            env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
                "--xla_force_host_platform_device_count=256")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, WORKER, "port-specs", str(tmp / "port.json")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        **{f"cells{i}": subprocess.Popen(
            [sys.executable, WORKER, "port-cells",
             str(tmp / f"cells{i}.json"),
             json.dumps(_cells()[i::2] + _mesh_cells()[i::2])],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i in range(2)}}
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, (name, err[-3000:])
        with open(tmp / f"{name}.json") as f:
            out[name] = json.load(f)
    out["cells"] = {**out.pop("cells0"), **out.pop("cells1")}
    return out


def test_shapes_equal_reference():
    import repro.configs as rc
    from repro.configs import shapes as ref_shapes
    from repro_torch import configs
    from repro_torch.configs import shapes
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in ref_shapes.SHAPES.items()}
    for arch in configs.ARCHS:
        for name in shapes.SHAPES:
            assert shapes.runnable(configs.get(arch), shapes.SHAPES[name]) \
                == ref_shapes.runnable(rc.get(arch),
                                       ref_shapes.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(runs, arch, shape):
    ref, port = runs["ref"][f"{arch}|{shape}"], runs["port"][f"{arch}|{shape}"]
    assert sorted(port) == sorted(ref)
    bad = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not bad, list(bad.items())[:4]


@pytest.mark.parametrize("key", [c[0] for c in _cells()])
def test_every_cell_reports(runs, key):
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, runnable
    rep = runs["cells"][key]
    arch, shape = key.split("|")
    assert "error" not in rep, rep["error"]
    ok, reason = runnable(configs.smoke(arch), SHAPES[shape])
    if not ok:
        assert rep["skipped"] == reason
        return
    # every family trains on a mesh: no cell is refused
    assert "refused" not in rep, rep["refused"]
    assert REPORT_KEYS <= set(rep), REPORT_KEYS - set(rep)
    assert rep["chips"] == 16 and rep["mesh"] == "4x4"
    assert rep["bottleneck"] in ("compute", "memory", "collective")
    assert rep["flops_per_device"] > 0 and rep["bytes_per_device"] > 0
    mem = rep["memory_stats"]
    assert mem["peak_bytes"] > 0 and rep["fits"] == mem["fits"]
    assert sum(mem["peak_by_category"].values()) == mem["peak_bytes"]
    kernels = rep["collectives"]["kernels"]
    if rep["packed"]:
        assert rep["cim_backend"] == "abstract"
        assert kernels.get("ternary_matmul", 0) > 0
        assert rep["collectives"]["packed_weight_bytes"] > 0
    else:
        assert not kernels
    if SHAPES[shape].kind == "train":
        # the step gathers each param and reduce-scatters each gradient
        counts = rep["collectives"]["counts"]
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
        assert rep["wire_bytes_per_device"] > 0


def test_cli_writes_report(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--smoke",
         "--mesh-shape", "2x2", "--packed", "trit2", "--decode-loop", "3",
         "--out-dir", str(tmp_path), "--tag", "t"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path /
              "internlm2-1.8b__decode_32k__2x2__trit2__smoke__t.json") as f:
        rep = json.load(f)
    assert rep["decode_loop"] == 3 and rep["tag"] == "t"
    # two decode steps of the rank's 64 rows: the mma route throughout
    assert rep["collectives"]["routes"] == {
        "mma": rep["collectives"]["kernels"]["ternary_matmul"]}
    assert "[ok]" in r.stdout


@pytest.mark.parametrize("flag", [dict(fidelity="device"),
                                  dict(fidelity="device", continuous=4),
                                  dict(fidelity="device", continuous=4,
                                       kv_layout="paged"),
                                  dict(fidelity="device", ep="data")])
def test_unported_flags_raise(flag):
    """Device fidelity on a mesh raises, alone and beside the flags the
    meshed schedulers and ep-data serve."""
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 8, part 3"):
        dryrun.run_cell("internlm2-1.8b", "decode_32k", smoke=True,
                        mesh_shape=(2, 2), **flag)


def test_cli_refuses_unported_flag():
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError, match="part 3"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                     "--fidelity", "device"])


def test_paged_needs_the_slot_pool():
    from repro_torch.launch import dryrun
    with pytest.raises(ValueError, match="requires --continuous"):
        dryrun.run_cell("internlm2-1.8b", "decode_32k", smoke=True,
                        mesh_shape=(2, 2), kv_layout="paged")


# the reference's meta keys of a scheduler cell (launch/dryrun.py)
CHUNK_KEYS = {"continuous_slots", "chunk"}
PAGED_KEYS = CHUNK_KEYS | {"kv_layout", "page_size", "num_pages"}


def test_xlstm_train_cell_traces(runs):
    """xlstm-125m's train step on the mesh, at 64 positions (its
    sLSTM's loop makes the 4096 of ``train_4k`` too slow here)."""
    rep = runs["cells"]["mesh|xlstm-train"]
    assert "error" not in rep and "refused" not in rep, rep
    assert REPORT_KEYS <= set(rep), REPORT_KEYS - set(rep)
    counts = rep["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    # the sLSTM's and mLSTM's f32 products
    assert rep["collectives"]["products"]["f32"] > 0


@pytest.mark.parametrize("key", list(ADAFACTOR_CELLS))
def test_adafactor_train_cells_report(runs, key):
    """``--opt adafactor`` on a smoke cell: the report names it, and its
    factored moments' means and RMS clips add all-reduces to the AdamW
    cell's (``--opt auto`` at smoke size)."""
    rep = runs["cells"][f"mesh|{key}"]
    arch = ADAFACTOR_CELLS[key]
    adamw = runs["cells"][f"{arch}|train_4k"]
    assert "error" not in rep and "refused" not in rep, rep
    assert REPORT_KEYS <= set(rep), REPORT_KEYS - set(rep)
    assert rep["optimizer"] == "adafactor" and adamw["optimizer"] == "adamw"
    counts, base = (r["collectives"]["counts"] for r in (rep, adamw))
    assert counts["all-reduce"] > base["all-reduce"]
    assert counts["reduce-scatter"] == base["reduce-scatter"] > 0
    assert rep["wire_bytes_per_device"] > adamw["wire_bytes_per_device"]


@pytest.mark.parametrize("key", list(MESH_CELLS))
def test_meshed_serving_cells_report(runs, key):
    rep = runs["cells"][f"mesh|{key}"]
    assert "error" not in rep and "refused" not in rep, rep
    assert REPORT_KEYS <= set(rep), REPORT_KEYS - set(rep)
    assert rep["chips"] == 16 and rep["mesh"] == "4x4"
    assert rep["memory_stats"]["peak_bytes"] > 0
    kw = MESH_CELLS[key][1]
    if kw.get("continuous"):
        assert (PAGED_KEYS if kw.get("kv_layout") == "paged"
                else CHUNK_KEYS) <= set(rep)
        assert rep["continuous_slots"] == 8
        assert rep["chunk"] == kw.get("decode_loop", 8)
        # the chunk's all-gather of the token buffer over data = 4
        assert rep["collectives"]["counts"]["all-gather"] > 0
    if kw.get("kv_layout") == "paged":
        # each of data = 4 stripes: a null page and 2 slots x 2048 pages
        assert (rep["kv_layout"], rep["page_size"], rep["num_pages"]) == \
            ("paged", 16, 4 * (1 + 2 * 2048))
    if kw.get("ep"):
        assert rep["ep"] == "data"
    if rep["packed"]:
        chunk = rep["collectives"]
        one = runs["cells"]["mesh|chunk1"]["collectives"]
        # 8 decode steps of the rank's 2 slots: 8 x one step's calls, on
        # the gemv route
        assert chunk["routes"] == {"gemv": chunk["kernels"][
            "ternary_matmul"]}
        assert chunk["kernels"]["ternary_matmul"] == \
            rep["chunk"] * one["kernels"]["ternary_matmul"] > 0


def test_expected_distinct():
    from repro_torch.launch.dryrun import expected_distinct
    assert expected_distinct(1, 100) == 1
    assert expected_distinct(10 ** 6, 512) == 512
    assert 7700 < expected_distinct(8192, 92544) < 7900


def _packed(k=256, n=128, mode="base3"):
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    return ops.pack_weights(torch.randn(k, n, generator=g) * 0.05, mode)


def test_abstract_platform_is_fake_and_meta_only():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.plan import platform_of, plan_matmul
    assert platform_of(torch.zeros(2)) == "cpu"
    assert platform_of(torch.zeros(2, device="meta")) == "abstract"
    with FakeTensorMode():
        assert platform_of(torch.zeros(2)) == "abstract"
    for backend in (None, "torch"):
        assert plan_matmul((8, 256, 128), platform="cpu",
                           backend=backend).backend != "abstract"
    assert plan_matmul((8, 256, 128), platform="abstract").backend == \
        "abstract"
    for real in ("cuda", "torch", "ref"):
        with pytest.raises(ValueError, match="does not support platform"):
            plan_matmul((8, 256, 128), platform="abstract", backend=real)
    with pytest.raises(ValueError, match="does not support platform"):
        plan_matmul((8, 256, 128), platform="cpu", backend="abstract")


@pytest.mark.parametrize("mode", ("base3", "trit2"))
@pytest.mark.parametrize("m", (8, 1024))
def test_abstract_backend_charges_the_kernel(mode, m):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.cim_linear import CIMConfig, linear
    from repro_torch.kernels import ops
    from repro_torch.roofline import OpCost
    w = _packed(mode=mode)
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fw = ops.PackedTernary(fm.from_tensor(w.data),
                               fm.from_tensor(w.scale), mode)
        x = torch.empty((m, 256), dtype=torch.bfloat16)
        with OpCost() as cost:
            y = linear(x, fw, CIMConfig(mode="ternary", packing=mode))
    assert tuple(y.shape) == (m, 128) and y.dtype == torch.float32
    assert cost.kernels == {"ternary_matmul": 1}
    assert cost.routes == {"gemv" if m <= 8 else "mma": 1}
    wbytes = w.data.numel() + 4 * 128
    assert cost.weight_bytes == wbytes
    assert cost.kernel_bytes == wbytes + 2 * m * 256 + 4 * m * 128
    assert cost.flops_by_rate["bf16"] == 2 * m * 256 * 128


def test_no_launcher_on_storage_free_tensors():
    from repro_torch.kernels import ternary_matmul as tm
    w = _packed()
    x = torch.empty((8, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tm.matmul_float(x, w.data.to("meta"), w.scale.to("meta"), "base3")
    with pytest.raises(ValueError, match="holds no storage"):
        tm._check_cuda(x)


def test_table_rows(tmp_path, runs):
    """``--table``: a traced cell's row holds float / base3, a cell
    without a trace is listed by why."""
    from repro_torch.launch import dryrun
    decode = runs["cells"]["internlm2-1.8b|decode_32k"]
    for packed, rep in ((None, dict(decode, packed=None)),
                        ("base3", decode)):
        with open(tmp_path / dryrun.cell_filename(
                "internlm2-1.8b", "decode_32k", "4x4", packed), "w") as f:
            json.dump(rep, f)
    with open(tmp_path / dryrun.cell_filename(
            "internlm2-1.8b", "long_500k", "4x4", None), "w") as f:
        json.dump(runs["cells"]["internlm2-1.8b|long_500k"], f)
    out = dryrun.table(str(tmp_path), mesh="4x4")
    row = [r for r in out.splitlines()
           if r.startswith("| internlm2-1.8b | decode_32k |")]
    assert len(row) == 1 and row[0].count(" / ") == 10
    assert "skipped: internlm2-1.8b long_500k" in out
    assert "missing: internlm2-1.8b train_4k" in out
