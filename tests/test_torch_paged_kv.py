"""The port's page pool (``repro_torch.models.paged_kv``) against the JAX
reference's, on the CPU, on the same seeded numpy pools and tables.

Bars: the gather, the per-step scatter and the admission scatter give
pools equal to the reference's, bitwise (they only move values); the
prefix keys are equal; the allocator follows the same sequence of ids,
refcounts, peaks and statistics.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.models import paged_kv as jpkv
from repro_torch import configs
from repro_torch.models import paged_kv as pkv

jax.config.update("jax_platform_name", "cpu")

L, P, PS, KV, HD = 2, 9, 4, 2, 8


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, P, PS, KV, HD)).astype(np.float32)
    v = rng.standard_normal((L, P, PS, KV, HD)).astype(np.float32)
    return (jpkv.PagedKVCache(jnp.asarray(k), jnp.asarray(v)),
            pkv.PagedKVCache(torch.from_numpy(k.copy()),
                             torch.from_numpy(v.copy())))


def _same(jpool, tpool):
    np.testing.assert_array_equal(np.asarray(jpool.k_pages),
                                  tpool.k_pages.numpy())
    np.testing.assert_array_equal(np.asarray(jpool.v_pages),
                                  tpool.v_pages.numpy())


def test_init_page_pool_matches_reference():
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    jpool = jpkv.init_page_pool(jcfg, 5, 4)
    tpool = pkv.init_page_pool(tcfg, 5, 4, "cpu")
    assert tuple(tpool.k_pages.shape) == jpool.k_pages.shape
    assert tpool.page_bytes == jpool.page_bytes
    assert tpool.nbytes == sum(x.nbytes for x in jpool if x is not None)
    assert (tpool.page_size, tpool.num_pages) == (4, 5)
    with pytest.raises(ValueError, match="null page"):
        pkv.init_page_pool(tcfg, 1, 4, "cpu")
    # an int8 pool: int8 code pages and f32 scale pages, as the
    # reference's
    jpool = jpkv.init_page_pool(
        dataclasses.replace(jcfg, kv_cache_dtype="int8"), 5, 4)
    tpool = pkv.init_page_pool(
        dataclasses.replace(tcfg, kv_cache_dtype="int8"), 5, 4, "cpu")
    for mine, ref in zip(tpool, jpool):
        assert tuple(mine.shape) == ref.shape
        assert str(mine.dtype).split(".")[-1] == ref.dtype.name
    assert tpool.page_bytes == jpool.page_bytes
    assert tpool.nbytes == sum(x.nbytes for x in jpool)


def test_slot_view_matches_reference():
    jpool, tpool = _pools()
    table = np.asarray([[3, 1, 0], [5, 5, 8]], np.int32)
    pos = np.asarray([6, 9], np.int32)
    got = pkv.slot_view(tpool, torch.from_numpy(table),
                        torch.from_numpy(pos))
    for i in range(2):                   # the reference gathers one slot
        want = jpkv.slot_view(jpool, jnp.asarray(table[i]),
                              jnp.asarray(pos[i]))
        one = pkv.slot_view(tpool, torch.from_numpy(table[i]), pos[i])
        for key in ("k", "v"):
            np.testing.assert_array_equal(one[key].numpy(),
                                          np.asarray(want[key]))
            np.testing.assert_array_equal(got[key][:, i].numpy(),
                                          np.asarray(want[key])[:, 0])
    assert got["k"].shape == (L, 2, 3 * PS, KV, HD)
    k_raw, v_raw = pkv.raw_pool_view(tpool)
    assert k_raw is tpool.k_pages and v_raw is tpool.v_pages


def test_append_tokens_matches_reference_and_routes_dead_slots():
    jpool, tpool = _pools(1)
    rng = np.random.default_rng(2)
    slots = 4
    kts = rng.standard_normal((slots, L, KV, HD)).astype(np.float32)
    vts = rng.standard_normal((slots, L, KV, HD)).astype(np.float32)
    table = np.asarray([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    # slot 1 is dead; slot 3 decodes scratch past its table width
    pos = np.asarray([2, 5, 7, 11], np.int32)
    live = np.asarray([True, False, True, True])
    want = jpkv.append_tokens(jpool, jnp.asarray(kts), jnp.asarray(vts),
                              jnp.asarray(table), jnp.asarray(pos),
                              jnp.asarray(live))
    before = tpool.k_pages.clone()
    got = pkv.append_tokens(tpool, torch.from_numpy(kts),
                            torch.from_numpy(vts), torch.from_numpy(table),
                            torch.from_numpy(pos), torch.from_numpy(live))
    assert got is tpool                       # updated in place
    _same(want, got)
    # the dead slot wrote its token to the null page, nowhere else
    np.testing.assert_array_equal(got.k_pages[:, 0, 0].numpy(),
                                  kts[1].astype(np.float32))
    changed = (got.k_pages != before).any(dim=(0, 3, 4)).nonzero().tolist()
    assert sorted(map(tuple, changed)) == [(0, 0), (1, 2), (6, 3), (8, 3)]


def test_write_prompt_pages_matches_reference():
    jpool, tpool = _pools(3)
    rng = np.random.default_rng(4)
    cap = 3 * PS
    slab_k = rng.standard_normal((L, 1, cap, KV, HD)).astype(np.float32)
    slab_v = rng.standard_normal((L, 1, cap, KV, HD)).astype(np.float32)
    ids, src = np.asarray([7, 2], np.int32), np.asarray([0, 2], np.int32)
    want = jpkv.write_prompt_pages(
        jpool, {"k": jnp.asarray(slab_k), "v": jnp.asarray(slab_v)},
        jnp.asarray(ids), jnp.asarray(src))
    got = pkv.write_prompt_pages(
        tpool,
        {"k": torch.from_numpy(slab_k), "v": torch.from_numpy(slab_v)},
        torch.from_numpy(ids), torch.from_numpy(src))
    _same(want, got)


def test_prefix_key_matches_reference():
    prompt = np.random.default_rng(5).integers(0, 512, 13).astype(np.int32)
    for page in range(3):
        assert pkv.prefix_key(prompt, page, 4) == \
            jpkv.prefix_key(prompt, page, 4)
    assert pkv.prefix_key(prompt, 0, 4) != pkv.prefix_key(prompt, 1, 4)


def test_allocator_refcounts_peak_and_rollback():
    a = pkv.PageAllocator(num_pages=6, page_size=4)
    ids = a.alloc(3)
    assert ids == [1, 2, 3]
    assert a.pages_in_use == 3 and a.peak_in_use == 3
    assert a.alloc(3) is None                # all-or-nothing
    assert a.pages_in_use == 3               # a failed alloc leaves no trace
    a.register_prefix(("k",), ids[0])
    assert a.lookup_prefix(("k",)) == ids[0]     # refcount 2
    assert a.lookup_prefix(("missing",)) is None
    a.release([ids[0]])
    assert a.pages_in_use == 3               # still referenced
    a.release(ids)
    assert a.pages_in_use == 0
    assert a.lookup_prefix(("k",)) is None   # unregistered on last release
    assert a.peak_in_use == 3
    assert a.prefix_hits == 1 and a.prefix_lookups == 3
    assert a.prefix_hit_rate == pytest.approx(1 / 3)
    assert pkv.PageAllocator(4, 4).prefix_hit_rate == 0.0


def test_allocator_follows_the_reference_op_by_op():
    rng = np.random.default_rng(6)
    ja, ta = jpkv.PageAllocator(12, 4), pkv.PageAllocator(12, 4)
    held = []
    for step in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(0, 5))
            got, want = ta.alloc(n), ja.alloc(n)
            assert got == want
            if got:
                held.extend(got)
        elif op == 1 and held:
            pid = held[int(rng.integers(0, len(held)))]
            key = ("p", int(rng.integers(0, 6)))
            if key in ta._prefix or pid in ta._key_of:
                continue                 # one key per page, one page per key
            ta.register_prefix(key, pid)
            ja.register_prefix(key, pid)
        elif op == 2:
            key = ("p", int(rng.integers(0, 6)))
            got, want = ta.lookup_prefix(key), ja.lookup_prefix(key)
            assert got == want
            if got is not None:
                held.append(got)
        elif held:
            pid = held.pop(int(rng.integers(0, len(held))))
            ta.release([pid])
            ja.release([pid])
        assert (ta.pages_in_use, ta.peak_in_use, ta.prefix_hits,
                ta.prefix_lookups) == (ja.pages_in_use, ja.peak_in_use,
                                       ja.prefix_hits, ja.prefix_lookups)
