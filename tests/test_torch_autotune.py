"""The port's measured tile autotuner (``repro_torch.kernels.autotune``):
persistence, plan resolution and the loud analysis gate, the cases of
``tests/test_autotune.py`` that have a torch meaning, on the CPU.

Fixture tables hold ``cuda`` entries of one card; plans of the ``cuda``
backend are resolved on the CPU (``platform='cuda'``) with the current
card's name set to the fixture's.  Also: both packages' ``canonical_bytes``
order one set of cells the same way in the same JSON layout."""
import json
import logging
import os
import random

import pytest

from _torch_threads import one_thread  # noqa: F401
from repro.kernels import autotune as ref_autotune
from repro_torch.analysis import autotune_table as autotune_pass
from repro_torch.kernels import autotune, plan_matmul
from repro_torch.kernels import ternary_matmul as tm

DEV = autotune.TRACKED_DEVICE
TRACKED = autotune.DEFAULT_TABLE

# one valid cell OUTSIDE the sweep (the tracked table never holds it):
# base3, float, gemv; the rule plans it (32, 4, 64) at 132 SMs
CELL = dict(m=8, k=256, n=256, phase="decode", platform="cuda",
            packing="base3", domain="float")
ENTRY = dict(CELL, device=DEV, blocks=[64, 2, 128], time_s=1e-5,
             heuristic_blocks=[32, 4, 64], heuristic_time_s=2e-5)
SHAPE = (CELL["m"], CELL["k"], CELL["n"])


def _write(tmp_path, entries, name="table.json"):
    path = tmp_path / name
    path.write_text(autotune.canonical_bytes(entries))
    return str(path)


def _plan(shape=SHAPE, **kw):
    kw.setdefault("packing", CELL["packing"])
    kw.setdefault("domain", CELL["domain"])
    return plan_matmul(shape, platform="cuda", **kw)


@pytest.fixture
def table_env(monkeypatch):
    """Point $REPRO_TORCH_AUTOTUNE_TABLE at a table, name the fixture's
    card as the current one, and reload (dropping the resolved plans);
    restored and reloaded afterwards."""
    monkeypatch.setattr(autotune, "current_device", lambda: DEV)

    def use(path):
        monkeypatch.setenv(autotune.ENV_VAR, path)
        autotune.reload_table()
        return path
    yield use
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.reload_table()


# ------------------------------------------------------- persistence


class TestPersistence:
    def test_round_trip_is_byte_identical(self, tmp_path):
        path = _write(tmp_path, [ENTRY])
        first = open(path).read()
        again = autotune.save_table(autotune.load_entries(path),
                                    str(tmp_path / "again.json"))
        assert open(again).read() == first

    def test_entry_order_cannot_change_the_bytes(self):
        e2 = dict(ENTRY, m=4, blocks=[64, 2, 128])
        e3 = dict(ENTRY, device="NVIDIA A100-SXM4-80GB")
        assert (autotune.canonical_bytes([ENTRY, e2, e3])
                == autotune.canonical_bytes([e3, e2, ENTRY]))

    def test_save_refuses_invalid_entries(self, tmp_path):
        bad = dict(ENTRY, blocks=[100, 2, 128])      # no 100-column tile
        with pytest.raises(ValueError, match="refusing to save"):
            autotune.save_table([bad], str(tmp_path / "bad.json"))

    def test_empty_env_var_disables_the_table(self, table_env):
        table_env("")
        assert autotune.lookup_blocks(**CELL) is None


# ----------------------------------------- plan-resolution integration


class TestPlanIntegration:
    def test_cold_miss_keeps_the_rule_and_logs_once(self, table_env,
                                                    caplog):
        table_env("")
        with caplog.at_level(logging.INFO, "repro_torch.kernels.autotune"):
            plan = _plan()
            autotune.lookup_blocks(**CELL)            # the same cell again
        d = plan.describe()
        assert d["backend"] == "cuda"
        assert d["block_source"] == "heuristic" and d["blocks"] is None
        misses = [r for r in caplog.records
                  if "autotune table miss" in r.message]
        assert len(misses) == 1

    def test_warm_hit_resolves_the_table_blocks(self, tmp_path, table_env):
        table_env(_write(tmp_path, [ENTRY]))
        d = _plan().describe()
        assert d["block_source"] == "autotune"
        assert d["blocks"] == ENTRY["blocks"]

    def test_pinned_blocks_win_over_the_table(self, tmp_path, table_env):
        table_env(_write(tmp_path, [ENTRY]))
        d = _plan(blocks=(128, 1, 256)).describe()
        assert d["block_source"] == "pinned"
        assert d["blocks"] == [128, 1, 256]

    def test_doctored_table_degrades_to_the_rule(self, tmp_path, table_env,
                                                 caplog):
        bad = dict(ENTRY, blocks=[64, 3, 128])        # no 3-block cluster
        path = tmp_path / "doctored.json"
        path.write_text(json.dumps({"version": autotune.TABLE_VERSION,
                                    "entries": [bad]}))
        with caplog.at_level(logging.WARNING,
                             "repro_torch.kernels.autotune"):
            table_env(str(path))
            d = _plan().describe()
        assert d["block_source"] == "heuristic" and d["blocks"] is None
        assert any("fails validation" in r.message for r in caplog.records)

    def test_another_cards_entry_never_steers(self, tmp_path, table_env):
        table_env(_write(tmp_path, [dict(ENTRY, device="another card")]))
        assert _plan().describe()["block_source"] == "heuristic"

    def test_the_key_is_the_route_phase_and_the_kernels_k(self, tmp_path,
                                                         table_env):
        """A layer's plan (phase 'auto') at trit2 K=2047 finds the
        decode cell at the padded K=2048; an mma shape finds prefill."""
        gemv = dict(ENTRY, k=2048, packing="trit2", blocks=[128, 2, 1024],
                    heuristic_blocks=[64, 8, 256])
        mma = dict(ENTRY, m=1024, k=2048, n=2048, phase="prefill",
                   domain="int8", blocks=[128, 2, 1024],
                   heuristic_blocks=[256, 2, 1024])
        table_env(_write(tmp_path, [gemv, mma]))
        d = _plan((8, 2047, 256), packing="trit2").describe()
        assert d["block_source"] == "autotune" and d["blocks"] == [128, 2,
                                                                   1024]
        d = _plan((1024, 2048, 2048), domain="int8").describe()
        assert d["block_source"] == "autotune"
        # the plain backends take no tiles, and never read the table
        d = _plan((1024, 2048, 2048), domain="int8",
                  backend="torch").describe()
        assert d["block_source"] == "heuristic" and d["blocks"] is None
        with pytest.raises(ValueError, match="takes no tiles"):
            _plan(backend="torch", blocks=(128, 1, 256))

    def test_a_pinned_plan_the_kernel_cannot_take_raises(self, table_env):
        table_env("")
        with pytest.raises(ValueError, match="block_n=100"):
            _plan(blocks=(100, 2, 128))


# -------------------------------------------------------- the loud gate


class TestAnalysisGate:
    def _findings(self, tmp_path, entries, doctor=None):
        payload = json.loads(autotune.canonical_bytes(entries))
        if doctor:
            doctor(payload)
        path = tmp_path / "t.json"
        path.write_text(json.dumps(payload, indent=2, sort_keys=True)
                        + "\n")
        return autotune_pass.run(table_path=str(path))

    def test_missing_table_is_a_finding(self, tmp_path):
        fs = autotune_pass.run(table_path=str(tmp_path / "absent.json"))
        assert [f.rule for f in fs] == ["AT004"]

    def test_structure_violation_at001(self, tmp_path):
        fs = self._findings(tmp_path, [ENTRY],
                            lambda p: p.__setitem__("version", 99))
        assert any(f.rule == "AT001" for f in fs)

    @pytest.mark.parametrize("bad", [
        dict(blocks=[64, 2, 96]),                  # splits not whole stages
        dict(blocks=[64, 2, 64]),                  # K left uncovered
        dict(blocks=[64, 8, 64]),                  # an empty cluster rank
        dict(phase="prefill"),                     # M=8 is a decode cell
        dict(m=1024, phase="prefill", blocks=[256, 1, 16384],
             heuristic_blocks=[256, 2, 8192], k=16384),  # past the chain
    ])
    def test_invariant_violation_at002(self, tmp_path, bad):
        fs = self._findings(tmp_path, [dict(ENTRY, **bad)])
        assert fs and all(f.rule == "AT002" for f in fs)

    def test_duplicate_cell_at003(self, tmp_path):
        dup = dict(ENTRY, blocks=[128, 1, 256])
        fs = self._findings(tmp_path, [ENTRY, dup])
        assert any(f.rule == "AT003" for f in fs)

    def test_stale_table_at004(self, tmp_path):
        entries = autotune.load_entries(TRACKED)[1:]
        fs = autotune_pass.run(table_path=_write(tmp_path, entries))
        assert [f.rule for f in fs] == ["AT004"]

    def test_non_canonical_serialization_at005(self, tmp_path):
        path = tmp_path / "t.json"
        payload = json.loads(autotune.canonical_bytes(
            autotune.load_entries(TRACKED)))
        path.write_text(json.dumps(payload))       # compact, no newline
        fs = autotune_pass.run(table_path=str(path))
        assert [f.rule for f in fs] == ["AT005"]

    def test_the_wrappers_refuse_what_the_gate_refuses(self):
        """AT002 and the wrappers read one contract: a plan the table's
        check refuses raises at the wrapper, never quietly becomes the
        rule's."""
        import torch
        bad = [64, 2, 96]
        fs = autotune.validate_table({"version": autotune.TABLE_VERSION,
                                      "entries": [dict(ENTRY, blocks=bad)]})
        assert fs and {r for r, _, _ in fs} == {"AT002"}
        x = torch.zeros(8, 256, dtype=torch.bfloat16)
        data = torch.zeros(256, 256, dtype=torch.uint8)
        scale = torch.ones(256)
        with pytest.raises(ValueError, match="whole stages"):
            tm.matmul_float(x, data, scale, "base3", tiles=tuple(bad))
        with pytest.raises(ValueError, match="takes no tiles"):
            tm.matmul_float(x.float(), data, scale, "base3",
                            tiles=(64, 2, 128))
        y = tm.matmul_float(x, data, scale, "base3", tiles=(64, 2, 128))
        assert y.shape == (8, 256)


# -------------------------------------------------- the tracked table


class TestTrackedTable:
    def test_tracked_table_is_clean(self):
        assert autotune_pass.run() == []

    def test_sweep_cells_resolve_from_the_table(self, table_env):
        table_env(TRACKED)
        entries = [e for e in autotune.load_entries(TRACKED)
                   if e["device"] == DEV]
        for e in entries[:: max(1, len(entries) // 8)]:
            d = _plan((e["m"], e["k"], e["n"]), packing=e["packing"],
                      domain=e["domain"]).describe()
            assert d["block_source"] == "autotune"
            assert d["blocks"] == e["blocks"]

    def test_measured_candidates_satisfy_the_invariants(self):
        """Every plan the tuner races passes the checks the gate holds
        the winner to, the rule's plan first."""
        for m, k, n in autotune.sweep_shapes():
            for packing in ("base3", "trit2"):
                for domain in ("float", "int8"):
                    cands = autotune.candidate_blocks(m, k, n, packing,
                                                      domain, 132)
                    rule = (tm.gemv_plan(m, k, n, packing, 132) if m <= 8
                            else tm.mma_plan(m, k, n, 132,
                                             tm.MMA_FLOAT_CHAIN
                                             if domain == "float" else None))
                    assert cands[0] == rule and len(set(cands)) == len(cands)
                    entries = [dict(ENTRY, m=m, k=k, n=n,
                                    phase=autotune.route_phase(m),
                                    packing=packing, domain=domain,
                                    blocks=list(c),
                                    heuristic_blocks=list(cands[0]),
                                    device=f"card {i}")
                               for i, c in enumerate(cands)]
                    assert autotune.validate_table(json.loads(
                        autotune.canonical_bytes(entries))) == []


def test_canonical_bytes_agree_with_the_reference():
    """The same cells, shuffled, serialize byte for byte as the
    reference's ``canonical_bytes`` lays them out."""
    entries = [dict(ENTRY, m=m, k=k, n=n, phase=autotune.route_phase(m),
                    packing=p, domain=d)
               for m, k, n in autotune.sweep_shapes()
               for p in ("base3", "trit2") for d in ("float", "int8")]
    random.Random(0).shuffle(entries)
    assert autotune.canonical_bytes(entries) == \
        ref_autotune.canonical_bytes(entries)
    assert autotune.TABLE_VERSION == ref_autotune.TABLE_VERSION
    assert os.path.basename(TRACKED) == "autotune_table.json"
