"""The port's ``shard`` analysis pass (``repro_torch.analysis.shardspec``,
SD001-SD006) and ``abscache``:

  * the pass is clean on the tree, through its function and the CLI;
  * each of the six injections trips exactly its rule, and the same rule
    ids as the reference's pass under the same injection;
  * SD006 fails on a drifted copy of ``src/repro_torch/dist/README.md``,
    SD005 on a typo'd axis in swept source;
  * the serving passes default to the card and raise without one.
"""
import os

import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.analysis import shardspec as ref_shardspec
from repro_torch.analysis import PASSES, abscache, frontend, sanitizer
from repro_torch.analysis import shardspec
from repro_torch.analysis.__main__ import main as cli_main

INJECTIONS = {"resolve": "SD001", "spec": "SD002", "replicate": "SD003",
              "mirror": "SD004", "axis": "SD005", "drift": "SD006"}


def test_shard_pass_is_clean_on_the_tree():
    assert "shard" in dict(PASSES)
    assert shardspec.run() == []
    assert cli_main(["--passes", "shard", "--device", "cpu"]) == 0


@pytest.mark.parametrize("inject", sorted(INJECTIONS))
def test_each_injection_trips_exactly_its_rule(inject):
    rules = {f.rule for f in shardspec.run(inject=inject)}
    assert rules == {INJECTIONS[inject]}
    assert all(f.passname == "shard"
               for f in shardspec.run(inject=inject))


@pytest.mark.parametrize("inject", ["resolve", "replicate", "axis",
                                    "drift"])
def test_rule_ids_match_the_reference(inject):
    ours = {f.rule for f in shardspec.run(inject=inject)}
    ref = {f.rule for f in ref_shardspec.run(
        inject=inject, archs=("internlm2-1.8b",))}
    assert ours == ref == {INJECTIONS[inject]}


@pytest.mark.parametrize("inject", sorted(INJECTIONS))
def test_cli_injection_exits_nonzero_naming_its_rule(inject, capsys):
    assert cli_main(["--passes", "shard", "--inject-shard", inject]) > 0
    assert f"shard:{INJECTIONS[inject]}" in capsys.readouterr().out


def test_sd006_fails_on_a_drifted_readme_copy(tmp_path):
    text = open(shardspec.DIST_README, encoding="utf-8").read()
    assert shardspec._check_readme_axes(shardspec.DIST_README) == []
    drifted = tmp_path / "README.md"
    drifted.write_text(text.replace("| `kv_seq` | - | `model` |",
                                    "| `kv_seq` | `model` | `model` |"))
    got = shardspec._check_readme_axes(str(drifted))
    assert [f.rule for f in got] == ["SD006"]
    assert "kv_seq" in got[0].message
    dropped = tmp_path / "dropped.md"
    dropped.write_text("\n".join(ln for ln in text.splitlines()
                                 if not ln.startswith("| `inner`")))
    assert any("inner" in f.message
               for f in shardspec._check_readme_axes(str(dropped)))


def test_emit_axes_renders_the_readme_table(capsys):
    assert cli_main(["--emit-axes"]) == 0
    table = shardspec.parse_axis_table(capsys.readouterr().out)
    assert table == shardspec.parse_axis_table(
        open(shardspec.DIST_README, encoding="utf-8").read())


def test_sd005_sweeps_the_port_and_catches_a_typo(tmp_path):
    known = shardspec._known_axes()
    src = os.path.join(shardspec.REPO_ROOT, "src", "repro_torch")
    assert shardspec.sweep_axes((src,), known) == []
    bad = tmp_path / "bad.py"
    bad.write_text('a = ParamSpec((4, 4), "ones", None, ("embed", "mpl"))\n'
                   'b = constrain_act(x, ("batch", "seq"))\n'
                   'c = place(x, ("layers", "hedas"), rules, mesh)\n')
    got = shardspec.sweep_axes((str(bad),), known)
    assert sorted(f.message.split("'")[1] for f in got) == ["hedas", "mpl"]
    assert {f.rule for f in got} == {"SD005"}


def test_abscache_memoises_and_builds_no_tensor():
    abscache.clear()
    shardspec.run()
    first = abscache.stats()
    shardspec.run()
    second = abscache.stats()
    assert second["param_leaves"]["misses"] == \
        first["param_leaves"]["misses"] == 10
    assert second["param_leaves"]["hits"] > first["param_leaves"]["hits"]
    leaves = abscache.param_leaves("internlm2-1.8b")
    assert all(len(d.axes) == len(d.shape) for _, d in leaves)
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(abscache.model("internlm2-1.8b")).values())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_serving_passes_default_to_the_card_and_raise_without_one():
    with pytest.raises(RuntimeError, match="cuda"):
        sanitizer.run()
    with pytest.raises(RuntimeError, match="cuda"):
        frontend.run()
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["--passes", "sanitize"])
