"""The port's compact mapping (``core/mapping.py``, Fig. 8) and energy,
area and capacity model (``core/energy.py``, Tables 4-5) against the
reference's ``repro.core.mapping`` and ``repro.core.energy``.  Both are
the same host Python over the same constants, so every public function
must give equal values (``==``): on ResNet-18 and VGG-9 (CIFAR), on an
LLM-scale layer list (the energy model's analytic restore count), at the
default ``MacroConfig`` and at a narrower one; and the reference's
mapping property check (``tests/test_properties.py``) holds on fixed
cases.  The port's first fit resumes each width's scan (the same
placements, held here); the reference's scans from slot 0, ~14 s for
ResNet-18 at the default config, so its plans are computed once per
argument set in this module (memoized) and ResNet-18 at the default
config is planned on 6 subarrays only."""
import dataclasses
import functools

import pytest

from _torch_threads import one_thread  # noqa: F401
from repro.core import energy as jenergy
from repro.core import mapping as jmapping
from repro.core.cim import MacroConfig as JMacroConfig
from repro_torch.core import energy, mapping
from repro_torch.core.cim import MacroConfig

MODELS = ("resnet18_cifar", "vgg9_cifar", "llm")
CONFIGS = {"default": {}, "narrow": dict(num_subarrays=3, rows_active=32,
                                         rerams_per_cluster=20)}
SCHEMES = ("tl", "sl", "sram_dram", "sram_reram", "reram_cim")


@pytest.fixture(autouse=True, scope="module")
def _reference_plans_once():
    """The reference's ``compact_map``, memoized per (layers, config,
    subarrays, duplicate) for this module, in both modules that call
    it."""
    plan = jmapping.compact_map

    @functools.lru_cache(maxsize=None)
    def once(layers, cfg, num_subarrays, duplicate):
        return plan(list(layers), cfg, num_subarrays, duplicate)

    def cached(layers, cfg=JMacroConfig(), num_subarrays=None,
               duplicate=False):
        n = cfg.num_subarrays if num_subarrays is None else num_subarrays
        return once(tuple(layers), cfg, n, duplicate)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmapping, "compact_map", cached)
        mp.setattr(jenergy, "compact_map", cached)
        yield


def _layers(mod, name):
    if name == "llm":         # 458,752 blocks a layer: the analytic branch
        return [mod.LayerSpec(f"w{i}", 8192, 28672, 1, 8) for i in range(2)]
    return getattr(mod, name)()


def _both(cfg):
    return MacroConfig(**CONFIGS[cfg]), JMacroConfig(**CONFIGS[cfg])


def _plain(x):
    """A dataclass (of either package) as nested plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def test_macro_config_and_constants_are_the_references():
    assert _plain(MacroConfig()) == _plain(JMacroConfig())
    mine, ref = MacroConfig(), JMacroConfig()
    for prop in ("trit_cols", "weights_per_row", "adcs", "trits_per_cell",
                 "subarray_weight_capacity_trits"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert _plain(energy.C) == _plain(jenergy.C)
    assert (energy.PJ, energy.FJ) == (jenergy.PJ, jenergy.FJ)


@pytest.mark.parametrize("name", MODELS)
def test_layer_specs_equal_the_references(name):
    mine, ref = _layers(mapping, name), _layers(jmapping, name)
    assert _plain(mine) == _plain(ref)
    for a, b in zip(mine, ref):
        assert (a.rows, a.cols(5), a.cols(8), a.params(), a.macs()) == \
            (b.rows, b.cols(5), b.cols(8), b.params(), b.macs())


@pytest.mark.parametrize("name,cfg,duplicate", [
    ("resnet18_cifar", "default", False), ("resnet18_cifar", "narrow", True),
    ("vgg9_cifar", "default", True), ("vgg9_cifar", "narrow", False)])
def test_compact_map_equals_the_references(name, cfg, duplicate):
    mc, jc = _both(cfg)
    mine = mapping.compact_map(_layers(mapping, name), mc,
                               duplicate=duplicate)
    ref = jmapping.compact_map(_layers(jmapping, name), jc,
                               duplicate=duplicate)
    assert _plain(mine) == _plain(ref)
    assert mine.fits == ref.fits
    assert mapping.subarrays_needed(_layers(mapping, name), mc) == \
        jmapping.subarrays_needed(_layers(jmapping, name), jc)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_throughput_cell_capacity_and_area_equal_the_references(cfg):
    mc, jc = _both(cfg)
    assert energy.macs_per_cycle(32, 16, 5) == jenergy.macs_per_cycle(
        32, 16, 5)
    assert energy.peak_throughput_ratio(mc) == \
        jenergy.peak_throughput_ratio(jc)
    assert energy.cell_metrics(mc) == jenergy.cell_metrics(jc)
    for scheme in ("tl", "sl", "sl_sel", "sram_dram", "sram_reram",
                   "reram_cim"):
        assert energy.array_capacity_bits(scheme, mc) == \
            jenergy.array_capacity_bits(scheme, jc), scheme
        assert energy.array_area_um2(scheme, mc) == \
            jenergy.array_area_um2(scheme, jc), scheme
        assert energy.arrays_to_fit(11.2e6, scheme, mc) == \
            jenergy.arrays_to_fit(11.2e6, scheme, jc), scheme
    with pytest.raises(ValueError):
        energy.array_capacity_bits("dram", mc)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", MODELS)
def test_inference_energy_equals_the_references(name, cfg):
    mc, jc = _both(cfg)
    mine, ref = _layers(mapping, name), _layers(jmapping, name)
    # the reference plans ResNet-18 on 2 subarrays in ~20 s
    caps = (None,) if (name, cfg) == ("resnet18_cifar", "default") \
        else (None, 2)
    for scheme in SCHEMES:
        for arrays in caps:
            assert _plain(energy.inference_energy(
                mine, scheme, mc, num_arrays=arrays)) == _plain(
                jenergy.inference_energy(ref, scheme, jc,
                                         num_arrays=arrays)), scheme
    for same in (False, True):
        assert energy.efficiency_ratios(mine, mc, same_area_sl=same) == \
            jenergy.efficiency_ratios(ref, jc, same_area_sl=same)
    assert energy.area_and_ee_per_area(mine, mc) == \
        jenergy.area_and_ee_per_area(ref, jc)
    with pytest.raises(ValueError):
        energy.inference_energy(mine, "hbm", mc)


@pytest.mark.parametrize("n_layers,cin,cout", [
    (1, 16, 16), (2, 64, 300), (3, 512, 512), (6, 512, 512), (4, 37, 211),
    (6, 200, 17)])
def test_mapping_places_everything_when_capacity_suffices(n_layers, cin,
                                                          cout):
    """The reference's property check on fixed cases, through the port,
    and the plan equal to the reference's."""
    layers = [mapping.LayerSpec(f"l{i}", cin, cout) for i in range(n_layers)]
    plan = mapping.compact_map(layers, MacroConfig(), num_subarrays=6)
    if plan.fits:
        blocks = {(p.layer, p.block_row, p.block_col)
                  for p in plan.placements}
        assert len(blocks) == plan.total_block_rows == len(plan.placements)
    assert plan.utilization <= 1.0 + 1e-9
    ref = jmapping.compact_map(
        [jmapping.LayerSpec(f"l{i}", cin, cout) for i in range(n_layers)],
        JMacroConfig(), num_subarrays=6)
    assert _plain(plan) == _plain(ref)
