"""The port's paged-attention read against the JAX reference, on the CPU.

Seeded numpy inputs go through the reference's gather oracle
(``paged_attention_ref``) and its Pallas kernel in interpret mode, and
through the port's plain version ``paged_attention_torch`` and its
wrapper (which takes the plain version on a CPU tensor).  The inputs hold
what the serving path gives the kernel: positions on and around page
boundaries, ``pos = 0`` slots (idle slots start there every chunk), slots
sharing prefix pages, and a null page (page 0) full of large finite
garbage that every unused table entry points at.

Bars (f32): ``m`` within 1e-5 * max(1, |m|); ``acc`` and ``l`` within 1e-4
of their per-row maximum.  The reference's own kernel and oracle differ by
up to ~2e-6 in ``m`` on this JAX version, and the summation orders of the
three implementations differ, so none of them is bitwise.

The CUDA kernel cannot run here, so its schedule is emulated in torch
(``_emulate``): ``paged_plan``'s window ranges per cluster rank, the
windows at or past ``pos`` left unloaded, the empty partials of dead
ranks, each warp's running softmax over its positions, and the merges in
warp order and then in rank order.  The emulation is held to the
reference at the same bars, and ``paged_plan``'s properties are checked
over drawn shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                         # offline image
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from _torch_threads import one_thread  # noqa: F401
from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plan_matmul, resolve_backend

jax.config.update("jax_platform_name", "cpu")

PS, W = 16, 32                            # page size, windows: capacity 512
POS = [0, 1, 15, 16, 17, 511, 512]        # page edges, empty and full slots
GARBAGE = 3.0e4


def _inputs(kvh=2, rep=2, hd=16, pos=POS, seed=0):
    rng = np.random.default_rng(seed)
    s = len(pos)
    num_pages = 1 + s * W
    q = rng.standard_normal((s, kvh, rep, hd)).astype(np.float32)
    q /= np.sqrt(hd)
    k = rng.standard_normal((num_pages, PS, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, PS, kvh, hd)).astype(np.float32)
    k[0] = GARBAGE * rng.choice([-1.0, 1.0], size=k[0].shape)
    v[0] = GARBAGE * rng.choice([-1.0, 1.0], size=v[0].shape)
    ids = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = np.zeros((s, W), np.int32)
    for i, p in enumerate(pos):
        n = -(-p // PS)                   # pages holding live positions
        table[i, :n] = ids[i * W: i * W + n]
    # slots 3 and 5 share slot 6's first page (a shared prompt prefix)
    table[3, 0] = table[5, 0] = table[6, 0]
    return q, k, v, table, np.asarray(pos, np.int32)


def _port(q, k, v, table, pos):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    return pa.PagedAttentionKV(t(k), t(v), t(table), t(pos)), t(q)


def _check(got, want):
    acc, m, l = (np.asarray(x) for x in got)
    acc_r, m_r, l_r = (np.asarray(x) for x in want)
    assert np.all(np.abs(m - m_r) <= 1e-5 * np.maximum(1.0, np.abs(m_r)))
    l_scale = np.abs(l_r)
    assert np.all(np.abs(l - l_r) <= 1e-4 * l_scale)
    acc_scale = np.abs(acc_r).max(axis=-1, keepdims=True)
    assert np.all(np.abs(acc - acc_r) <= 1e-4 * acc_scale)


@pytest.mark.parametrize("kvh,rep,hd", [(2, 2, 16), (1, 4, 8)])
def test_plain_version_matches_reference_oracle(kvh, rep, hd):
    q, k, v, table, pos = _inputs(kvh, rep, hd)
    want = jpa.paged_attention_ref(
        jnp.asarray(q), jpa.PagedAttentionKV(jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(table),
                                             jnp.asarray(pos)))
    kv, tq = _port(q, k, v, table, pos)
    got = pa.paged_attention_torch(tq, kv)
    _check([x.numpy() for x in got], want)
    # the pos = 0 slot: m = -1e30 and l = every position of its table
    m, l = got[1].numpy(), got[2].numpy()
    assert np.all(m[0] == np.float32(pa.NEG_INF))
    assert np.all(l[0] == W * PS)


def test_plain_version_matches_reference_pallas_kernel():
    q, k, v, table, pos = _inputs()
    want = jpa.paged_attention(
        jnp.asarray(q), jpa.PagedAttentionKV(jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(table),
                                             jnp.asarray(pos)),
        interpret=True)
    kv, tq = _port(q, k, v, table, pos)
    _check([x.numpy() for x in pa.paged_attention_torch(tq, kv)], want)


def test_null_page_contributes_exactly_zero_to_live_slots():
    q, k, v, table, pos = _inputs()
    kv, tq = _port(q, k, v, table, pos)
    k0, v0 = k.copy(), v.copy()
    k0[0] = 0.0
    v0[0] = 0.0
    kv0, _ = _port(q, k0, v0, table, pos)
    got = pa.paged_attention_torch(tq, kv)
    clean = pa.paged_attention_torch(tq, kv0)
    live = pos > 0
    for a, b in zip(got, clean):
        assert torch.equal(a[live], b[live])


def test_cpu_wrapper_is_the_plain_version():
    q, k, v, table, pos = _inputs(seed=3)
    kv, tq = _port(q, k, v, table, pos)
    pa.reset_launches()
    got = pa.paged_attention(tq, kv)
    want = pa.paged_attention_torch(tq, kv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pa.LAUNCHES["paged_attention"] == 0     # no kernel on the CPU


def test_shape_checks():
    q, k, v, table, pos = _inputs()
    kv, tq = _port(q, k, v, table, pos)
    with pytest.raises(ValueError, match="q \\(slots, KV, rep, hd\\)"):
        pa.paged_attention(tq[0], kv)
    with pytest.raises(ValueError, match="does not match q"):
        pa.paged_attention(tq[..., :8], kv)
    with pytest.raises(ValueError, match="does not match q"):
        pa.paged_attention(tq, kv._replace(v_pages=kv.v_pages[:-1]))
    with pytest.raises(ValueError, match="do not cover"):
        pa.paged_attention(tq, kv._replace(page_table=kv.page_table[:-1]))
    with pytest.raises(ValueError, match="do not cover"):
        pa.paged_attention(tq, kv._replace(pos=kv.pos[:-1]))
    assert kv.shape == (16, W * PS)


def test_attention_plans_resolve_the_kernel_on_the_card_only():
    shape = (8 * 16, 128, 512)
    on_card = plan_matmul(shape, platform="cuda", op="attention",
                          kv_layout="paged")
    assert on_card.backend == "paged_attn" and on_card.kv_layout == "paged"
    on_cpu = plan_matmul(shape, platform="cpu", op="attention",
                         kv_layout="paged")
    assert on_cpu.backend == "paged_attn_torch"
    named = plan_matmul(shape, platform="cuda", op="attention",
                        kv_layout="paged", backend="paged_attn_torch")
    assert named.backend == "paged_attn_torch"
    with pytest.raises(ValueError, match="no registered backend"):
        plan_matmul(shape, platform="cuda", op="attention")   # dense
    with pytest.raises(ValueError, match="no registered backend"):
        plan_matmul(shape, platform="cuda", op="attention",
                    kv_layout="paged", domain="int8")
    with pytest.raises(ValueError, match="does not support platform"):
        plan_matmul(shape, platform="cpu", op="attention",
                    kv_layout="paged", backend="paged_attn")
    # the matmul backends serve both layouts
    assert resolve_backend("ternary", platform="cuda",
                           kv_layout="paged").name == "cuda"
    with pytest.raises(ValueError, match="unknown kv layout"):
        resolve_backend("ternary", platform="cuda", kv_layout="ragged")


# ------------------------------------------------- the kernel's schedule

def _emulate(q, kv, plan):
    """The CUDA kernel's arithmetic order in torch f32, with the windows
    each rank loads: ``((acc, m, l), {(slot, rank): [windows]})``.  A warp
    of row group c takes every wpc-th step of `plan.step` positions of
    each window and updates its running softmax per step."""
    s, kvh, rep, hd = q.shape
    ps, w = kv.k_pages.shape[1], kv.page_table.shape[1]
    q, kp, vp = q.float(), kv.k_pages.float(), kv.v_pages.float()
    acc = torch.zeros(s, kvh, rep, hd)
    m = torch.zeros(s, kvh, rep)
    l = torch.zeros(s, kvh, rep)
    loaded = {}
    rows, step, wpc = plan.rows, plan.step, plan.warps_per_chunk

    def merge(parts):           # [(m, l, acc)] in order -> (m, l, acc)
        mm = torch.stack([p[0] for p in parts]).amax(dim=0)
        ll, aa = torch.zeros_like(mm), torch.zeros(mm.shape + (hd,))
        for pm, pl, pa_ in parts:
            e = torch.exp(pm - mm)
            ll = ll + pl * e
            aa = aa + pa_ * e[:, None]
        return mm, ll, aa

    for i in range(s):
        pos = int(kv.pos[i])
        # the windows a slot loads: those holding a position below pos, or
        # all of them at pos = 0, whose statistics span the whole table
        nlive = w if pos <= 0 else min(w, -(-pos // ps))
        for z in range(plan.splits):
            w0 = z * plan.per_rank
            loaded[i, z] = list(range(w0, min(w, w0 + plan.per_rank,
                                               max(nlive, w0))))
        for h in range(kvh):
            ranks = []
            for z in range(plan.splits):
                wins = loaded[i, z]
                if not wins:            # a dead rank's empty partial
                    ranks.append((torch.full((rep,), -torch.inf),
                                  torch.zeros(rep), torch.zeros(rep, hd)))
                    continue
                chunks = []
                for c in range(plan.chunks):
                    r = slice(c * rows, min(rep, (c + 1) * rows))
                    qc = q[i, h, r]
                    warps = []
                    for u in range(wpc):
                        wm = torch.full((qc.shape[0],), -torch.inf)
                        wl = torch.zeros(qc.shape[0])
                        wa = torch.zeros(qc.shape[0], hd)
                        for win in wins:
                            page = int(kv.page_table[i, win])
                            for t0 in range(u * step, ps, wpc * step):
                                t = torch.arange(t0, min(ps, t0 + step))
                                k, v = kp[page, t, h], vp[page, t, h]
                                sc = qc @ k.T
                                sc = torch.where(win * ps + t < pos, sc,
                                                 torch.tensor(pa.NEG_INF))
                                m_new = torch.maximum(wm, sc.amax(dim=1))
                                corr = torch.exp(wm - m_new)
                                p = torch.exp(sc - m_new[:, None])
                                wl = wl * corr + p.sum(dim=1)
                                wa = wa * corr[:, None] + p @ v
                                wm = m_new
                        warps.append((wm, wl, wa))
                    chunks.append(merge(warps))
                ranks.append(tuple(torch.cat(x) for x in zip(*chunks)))
            m[i, h], l[i, h], acc[i, h] = merge(ranks)
    return (acc, m, l), loaded


def _schedule_inputs(kvh, rep, hd, pos, null_slots=(), seed=0):
    """`_inputs`, plus idle slots whose whole table is the null page.  Such
    a slot reads the null page as live keys, so there it holds stale
    values of the data's scale: ±3e4 garbage as live keys gives scores
    that cancel terms of ~1e4, where no two summation orders agree within
    the bars (the reference's own kernel and oracle differ by ~1e-3 in
    m)."""
    q, k, v, table, pos = _inputs(kvh, rep, hd, pos, seed)
    if null_slots:
        rng = np.random.default_rng(seed + 1)
        k[0] = rng.standard_normal(k[0].shape)
        v[0] = rng.standard_normal(v[0].shape)
    for i in null_slots:
        table[i] = 0
    return q, k, v, table, pos


def _reference(q, k, v, table, pos, kernel=False):
    kv = jpa.PagedAttentionKV(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(table), jnp.asarray(pos))
    if kernel:
        return jpa.paged_attention(jnp.asarray(q), kv, interpret=True)
    return jpa.paged_attention_ref(jnp.asarray(q), kv)


# pos = 0 slots; 1, 15, 16, 17: every rank but the first dead (4 windows
# a rank); 511, 512: every rank live; 3 (slot 7, on the null page in the
# idle-slot cases)
SCHED_POS = [0, 1, 15, 16, 17, 511, 512, 3]
SCHED_CASES = [
    pytest.param(2, 2, 16, 132, id="serve-grouping"),
    pytest.param(2, 16, 16, 132, id="glm4-grouping-hd16"),
    pytest.param(1, 3, 8, 4, id="rep3-two-ranks"),
    pytest.param(2, 2, 16, 1, id="one-rank"),
]


@pytest.mark.parametrize("kvh,rep,hd,sms", SCHED_CASES)
@pytest.mark.parametrize("null", ["garbage", "idle-slot"])
@pytest.mark.parametrize("kernel", [False, True], ids=["oracle", "pallas"])
def test_kernel_schedule_matches_reference(kvh, rep, hd, sms, null, kernel):
    """The emulated schedule against the reference's gather oracle and
    its interpret-mode Pallas kernel, on pos = 0 slots, slots with only
    the first rank live, shared prefix pages, and either a null page full
    of garbage or an idle slot with pos > 0 whose table is all null page
    (slot 7)."""
    q, k, v, table, pos = _schedule_inputs(
        kvh, rep, hd, SCHED_POS, null_slots=(7,) if null == "idle-slot"
        else ())
    kv, tq = _port(q, k, v, table, pos)
    plan = pa.paged_plan(len(pos), kvh, rep, hd, PS, W, 4, sms)
    got, loaded = _emulate(tq, kv, plan)
    _check([x.numpy() for x in got],
           _reference(q, k, v, table, pos, kernel))
    m, l = got[1].numpy(), got[2].numpy()
    assert np.all(m[0] == np.float32(pa.NEG_INF))      # the pos = 0 slot
    assert np.all(l[0] == W * PS)
    # what was loaded: every window of a pos = 0 slot, else only live ones
    for (i, z), wins in loaded.items():
        if pos[i] == 0:
            assert wins, "a pos = 0 slot walks every window"
        else:
            assert all(win * PS < pos[i] for win in wins)


def test_dead_ranks_and_the_skip_at_the_serve_plan():
    """At the serve plan (8 ranks of 4 windows) slots below 65 positions
    load only rank 0's live windows, and a full slot loads all 32."""
    plan = pa.paged_plan(8, 2, 2, 16, PS, W, 4)
    assert (plan.splits, plan.per_rank) == (8, 4)
    q, k, v, table, pos = _schedule_inputs(2, 2, 16, SCHED_POS,
                                           null_slots=(7,))
    kv, tq = _port(q, k, v, table, pos)
    _, loaded = _emulate(tq, kv, plan)
    per_slot = {i: [w for z in range(8) for w in loaded[i, z]]
                for i in range(len(pos))}
    live_ranks = {i: [z for z in range(8) if loaded[i, z]]
                  for i in range(len(pos))}
    assert per_slot[0] == list(range(W))
    assert per_slot[1] == per_slot[2] == per_slot[3] == [0]
    assert per_slot[4] == [0, 1] and per_slot[7] == [0]
    assert per_slot[5] == per_slot[6] == list(range(W))
    for i in (1, 2, 3, 4, 7):
        assert live_ranks[i] == [0]


def test_emulated_null_page_is_exactly_zero_for_live_slots():
    """The schedule never loads a window at or past pos, so a live slot's
    statistics are bitwise the same with the null page zeroed."""
    q, k, v, table, pos = _schedule_inputs(2, 2, 16, SCHED_POS)
    plan = pa.paged_plan(len(pos), 2, 2, 16, PS, W, 4)
    kv, tq = _port(q, k, v, table, pos)
    k0, v0 = k.copy(), v.copy()
    k0[0] = 0.0
    v0[0] = 0.0
    kv0, _ = _port(q, k0, v0, table, pos)
    got, _ = _emulate(tq, kv, plan)
    clean, _ = _emulate(tq, kv0, plan)
    live = pos > 0
    for a, b in zip(got, clean):
        assert torch.equal(a[live], b[live])


# ------------------------------------------------------------ paged_plan

def _check_plan(slots, kvh, rep, hd, ps, w, elem, sms=132):
    plan = pa.paged_plan(slots, kvh, rep, hd, ps, w, elem, sms)
    assert plan.splits in pa.CLUSTERS and plan.splits <= 8
    ranges = [range(z * plan.per_rank, min(w, (z + 1) * plan.per_rank))
              for z in range(plan.splits)]
    covered = [win for r in ranges for win in r]
    assert covered == list(range(w))      # each window once, in rank order
    assert all(len(r) > 0 for r in ranges)
    assert plan.rows in (1, 2, 4, 8) and plan.rows * plan.chunks >= rep
    assert (plan.chunks - 1) * plan.rows < rep
    assert plan.rows * plan.step == 8           # 8 scores a warp step
    assert 1 <= plan.warps_per_chunk <= min(-(-ps // plan.step), 4)
    assert plan.threads == 32 * plan.chunks * plan.warps_per_chunk <= 256
    assert 2 <= plan.stages <= pa.MAX_STAGES
    assert plan.smem == pa.smem_bytes(
        rep, hd, ps, plan.per_rank, plan.rows,
        plan.chunks * plan.warps_per_chunk, plan.stages, elem)
    assert plan.smem <= pa.SMEM_LIMIT
    ring = plan.stages * 2 * ps * hd * elem     # K and V of `stages` pages
    if plan.stages > 2:
        assert ring <= pa.RING_BUDGET
    # the ring, and the rank's (acc, m, l) partial beside the warps'
    assert plan.smem >= max(ring, (rep * hd + 2 * rep) * 4)
    return plan


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 64), st.integers(1, 16), st.integers(1, 64),
       st.integers(1, 256), st.sampled_from([1, 4, 5, 16, 32, 64]),
       st.integers(1, 160), st.sampled_from([2, 4]))
def test_paged_plan_properties(slots, kvh, rep, hd, ps, w, elem):
    """Every window is covered by exactly one rank, no rank is empty, the
    cluster is at most 8, the block at most 256 threads, and shared
    memory stays within what the plan opts into."""
    try:
        _check_plan(slots, kvh, rep, hd, ps, w, elem)
    except ValueError as e:
        # refused only where two stages of pages alone do not fit (the
        # warps' partials and the page ids take under 70 KB here)
        assert "shared memory" in str(e)
        assert 4 * ps * hd * elem > pa.SMEM_LIMIT - 70 * 1024


@pytest.mark.parametrize("rep,hd", [(1, 256), (2, 128), (8, 256), (16, 128),
                                    (32, 64), (64, 32), (3, 40), (5, 200)])
@pytest.mark.parametrize("elem", [2, 4])
def test_paged_plan_takes_grouped_queries_up_to_2048_lanes(rep, hd, elem):
    """rep x hd up to 2048 (glm4-9b's 16 x 128 included) is taken at the
    serving page size, in bf16 and f32."""
    _check_plan(8, 2, rep, hd, 16, 32, elem)


def test_paged_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_plan(8, 2, 2, 264, 16, 32, 2)
    with pytest.raises(ValueError, match="grouped queries"):
        pa.paged_plan(8, 1, 65, 16, 16, 32, 2)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_plan(8, 8, 2, 128, 512, 4, 2)    # 256 KB pages
    with pytest.raises(ValueError, match="empty"):
        pa.paged_plan(8, 8, 2, 128, 16, 0, 2)


def test_paged_plan_at_the_main_path_shapes():
    """On 132 SMs: the serve shape (8 slots x 8 KV heads) takes clusters
    of 8 (512 blocks), 4 windows a rank, steps of 2 rows x 4 positions and
    a 4-deep ring of 32 KB, under 48 KB in all; capacity 2048 16 windows a rank; glm4-9b's
    grouping (2 KV x 16) two row groups of 4 warps, steps of 8 rows x 1
    position, 8 ranks."""
    serve = _check_plan(8, 8, 2, 128, 16, 32, 2)
    assert serve[:8] == (8, 4, 2, 4, 1, 4, 128, 4)
    assert 8 * 8 * serve.splits == 512 and serve.smem <= 48 * 1024
    assert (serve.stages * 2 * 16 * 128 * 2) == 32 * 1024
    assert _check_plan(8, 8, 2, 128, 16, 128, 2)[:8] == (8, 16, 2, 4, 1, 4,
                                                          128, 4)
    glm4 = _check_plan(8, 2, 16, 128, 16, 32, 2)
    assert glm4[:8] == (8, 4, 8, 1, 2, 4, 256, 4)
    # many slots fill the card without splitting
    assert _check_plan(64, 16, 2, 128, 16, 32, 2).splits == 1
