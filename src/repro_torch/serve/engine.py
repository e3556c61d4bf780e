"""Batched serving engine over the model's prefill/decode interface.

Requests are queued, bucketed by prompt length (equal lengths batch
exactly, no padding), prefilled as a batch, then decoded greedily with
per-row EOS and max-token termination.

Two decode loops give identical tokens:
  on-device loop (default) - the live mask, per-row budgets, the token
      buffer and the step count stay on the device; the host transfers
      them ONCE per bucket.  The reference's loop exits as soon as no row
      is live; a host-side exit test would need a sync every step, so
      this loop runs the bucket's ``max_new - 1`` steps (no row can be
      live after them) and counts on the device only the steps that
      started with a live row.  Tokens, counts and ``steps_run`` equal
      the reference's; rows that already finished keep decoding into
      discarded scratch, as in any fixed-batch serving.
  legacy step loop (``on_device_loop=False``) - one host sync per step.

``host_transfers`` counts device-to-host syncs, so the one-transfer-per-
bucket contract is testable.

On a DeviceMesh (``ServeEngine``, ``Scheduler`` and ``PagedScheduler``
with ``rules=, mesh=``; the dense and MoE families, both domains and
exact mode; ``dist.runtime``) the params are DTensors placed by
``rules_for(cfg, "serve")``, and every call runs on their compute view,
built once per engine (packed weights tensor-parallel over ``model``,
packed experts split over their expert axis).  Each rank prefills and
decodes its rows: the bucket folded over the DP axes, or the slot
pool's slots split over them (``dist.sharding.slot_spmd_axes``; a pool
that does not divide is replicated, as in the reference).  The decode
state is plain rank-local rows at every position, the same on every rank
of ``model``: it is not placed by its ``cache_specs`` (sharding its
positions over ``model`` needs an attention read that combines the
ranks' partial softmax, ROADMAP queue 1 item 8).  The calls run inside
``dist.runtime.row_block``, so MoE routing groups and the exact mode's
per-call input scale are the whole call's.  The rows' token buffers are
gathered before the bucket's or the chunk's one transfer.  Every rank
of a scheduler runs the same host scheduler: the arrival pump agrees on
its clock over a host (gloo) group, admission is FIFO, and a slot's
prefill and admission write run on the DP group that owns the slot (on
every rank where the experts lie on a DP axis the slots split over:
``ep-data``).  The paged pool stripes its pages over the slots' DP
ranks, each stripe with its own null page, allocator and prefix
registry, so prefixes are shared within a stripe.  On a one-card mesh
nothing moves: the kernels, their launches and the tokens are the
unmeshed engine's.

``extra_inputs`` (every engine) maps a ``prefill`` keyword to a function
of the batch size that gives that input for the batch: whisper's
``frames`` and the VLM's ``patches``, (B, positions, d_model).  Each
prefill calls them, moves the result to the engine's device in the
model's dtype, and passes it on, as the reference's ``_batch_inputs``
does; a request carries no input of its own.  The encoder's or the
patches' keys and values are then part of the decode state, so the slot
pools hold them as lanes (``xk``/``xv``) and copy them once per
admission.

Continuous batching (:class:`Scheduler`): a persistent pool of ``slots``
decode lanes whose device state (KV, position, live mask, per-slot
budgets) survives across scheduling rounds.  Each round runs one chunk
of ``chunk`` batched decode steps, every slot at its own position, then
makes ONE device-to-host transfer (``host_transfers == chunks_run``);
the host retires finished slots from it and prefills arrived requests
into the freed slots.  The reference's chunk loop exits as soon as no
slot is live; a host-side exit test would cost a sync every step, so
this loop runs all ``chunk`` steps and counts on the device the steps
that began with a live slot (``steps``) and the live slot-steps
(``occ``).  Dead and empty slots keep decoding into scratch.
:class:`PagedScheduler` keeps the KV in a paged, prefix-shared pool
(``models/paged_kv.py``) and reads it through the ``paged_attention``
kernel.

Device fidelity (``CIMConfig(fidelity="device")``): engines resolve the
config once per phase, so decode runs the fault-injected ``device``
backend and prefill an exact one.  The schedulers then serve from a
SERVED copy of the packed weights, restored at power-on from the
pristine tree through the campaign's restore channel, disturbed before
every chunk (drift keyed by ``chunks_run``) and restored again every
``scrub_every`` chunks (``repro_torch.faults``).  The ADC probe's two
counters ride the chunk's one transfer.  Where the reference decodes one
slot per call (the dense pool and the paged gather read), the device MAC
takes each slot's row as its own call (``decode_per_slot``); the fused
paged read is one call over every slot, as the reference's is.  Under
exact fidelity every hook is inert.

The same per-slot rule holds in the macro-exact mode
(``CIMConfig(mode="exact")``): the reference quantizes each call's
activations with one scale, so inside ``kernels.plan.rows_as_calls``
the exact cim plans give each slot's row its own scale, where the
reference decodes one slot per call.  It holds for MoE routing too
(``models/moe.py``): there each slot's row forms its own routing group
(one token, capacity 1 per expert for mixtral), where a group of every
slot would drop assignments that the reference keeps.  The bucket
engine's batch is one group, as the fused paged read's slots are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import faults, resolve_device, tree
from ..core import prng
from ..dist import mesh as mesh_lib
from ..dist import runtime as dist_rt
from ..dist import sharding as shd
from ..kernels.plan import rows_as_calls
from ..models import paged_kv

_LOG = logging.getLogger("repro_torch.serve.engine")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                      # (S,) int token ids
    max_new: int = 16
    eos_id: int = -1                 # -1: never
    arrival_s: float = 0.0           # offset from serve start (traces)
    priority: int = 0                # SLO class: lower is more urgent
    deadline_s: Optional[float] = None   # RELATIVE completion budget
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0           # trace runs: completion - arrival
    admit_s: float = 0.0             # trace runs: admission - serve start

    @property
    def deadline_met(self) -> bool:
        """True when the request carries no deadline or completed within
        its relative budget (``latency_s <= deadline_s``).  The engines
        carry ``priority`` and ``deadline_s`` untouched (they admit FIFO
        by ``(arrival_s, uid)``); the front-end's admission policies read
        them (``repro_torch.frontend``)."""
        return self.deadline_s is None or self.latency_s <= self.deadline_s


def percentile(vals: list, q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    return float(np.percentile(vals, 100.0 * q))


def latency_stats(reqs: list) -> dict:
    """p50/p99/p999/mean request latency plus the queue-wait vs service
    split (queue wait = admission - arrival, clamped into [0, latency])."""
    zero = {"p50_s": 0.0, "p99_s": 0.0, "p999_s": 0.0, "mean_s": 0.0,
            "queue_wait_mean_s": 0.0, "queue_wait_p99_s": 0.0,
            "service_mean_s": 0.0, "service_p99_s": 0.0}
    if not reqs:
        return zero
    lat = sorted(r.latency_s for r in reqs)
    waits = sorted(min(max(r.admit_s - r.arrival_s, 0.0), r.latency_s)
                   for r in reqs)
    service = sorted(max(r.latency_s
                         - min(max(r.admit_s - r.arrival_s, 0.0),
                               r.latency_s), 0.0) for r in reqs)
    return {"p50_s": round(percentile(lat, 0.50), 4),
            "p99_s": round(percentile(lat, 0.99), 4),
            "p999_s": round(percentile(lat, 0.999), 4),
            "mean_s": round(sum(lat) / len(lat), 4),
            "queue_wait_mean_s": round(sum(waits) / len(waits), 4),
            "queue_wait_p99_s": round(percentile(waits, 0.99), 4),
            "service_mean_s": round(sum(service) / len(service), 4),
            "service_p99_s": round(percentile(service, 0.99), 4)}


class _EngineBase:
    """Queue, completion list and the counted device-to-host chokepoint."""

    def __init__(self, model, params, capacity: int, cim, device,
                 extra_inputs=None):
        self.model = model
        self.extra_inputs = dict(extra_inputs or {})
        self.params = params
        self.capacity = capacity
        self.device = resolve_device(device)
        # resolve the plan request once per phase, against the engine's
        # platform, so an incapable backend fails here and not mid-decode;
        # a device request runs decode on the device backend and prefill
        # on an exact one (for an exact request the two are equal)
        if cim is None:
            self.cim = self.cim_prefill = None
        else:
            self.cim = cim.resolve(self.device.type)
            self.cim_prefill = cim.resolve(self.device.type, phase="prefill")
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.steps_run = 0
        self.host_transfers = 0
        self.mesh = None
        self.rules = None
        self._view = None
        self._split = None

    def _setup_mesh(self, rules, mesh, what: str) -> None:
        """Serve on ``mesh``: the request checked, the params placed by
        ``rules`` (the model's serve rules by default) unless they are,
        and their compute view built once (a collective: every rank
        constructs the engine)."""
        dist_rt.check_mesh_request(self.model, self.cim, what, "serve")
        self.mesh = mesh
        self.rules = rules or shd.rules_for(self.model.cfg, "serve")
        if not any(dist_rt.is_dtensor(getattr(x, "data", x))
                   for x in tree.leaves(self.params)):
            self.params = dist_rt.place_tree(
                self.params, self.model.param_specs, self.rules, mesh)
        self._view = dist_rt.param_view(self.params)

    @property
    def _cparams(self):
        """The params the model runs on: the compute view on a mesh."""
        return self.params if self.mesh is None else self._view

    def _meshed(self, split=None):
        """The activation context and the row split ``split`` of a meshed
        call (nothing off-mesh)."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(shd.activation_context(self.rules,
                                                       self.mesh))
            stack.enter_context(dist_rt.row_block(split))
        return stack

    def submit(self, req: Request):
        self.queue.append(req)

    def _device_get(self, x: torch.Tensor) -> np.ndarray:
        """Every device-to-host sync goes through here (counted)."""
        self.host_transfers += 1
        return x.cpu().numpy()

    def _upload(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the engine's device without a host sync: a host tensor
        bound for the card goes through pinned memory and is copied in
        stream order (a pageable copy would wait for the stream's queued
        work)."""
        if x.device.type != "cpu" or self.device.type != "cuda":
            return x.to(self.device)
        return x.contiguous().pin_memory().to(self.device, non_blocking=True)

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.out_tokens) for r in self.completed)

    def _batch_inputs(self, b: int) -> dict:
        """Each of ``extra_inputs`` for a batch of `b`, on the engine's
        device in the model's dtype."""
        return {name: self._upload(fn(b).to(dtype=self.model.cfg.dtype))
                for name, fn in self.extra_inputs.items()}

    def _prefill(self, reqs: list[Request]):
        tokens = self._upload(torch.stack([
            torch.as_tensor(np.asarray(r.prompt), dtype=torch.int32)
            for r in reqs]))
        with self._meshed():
            logits, state = self.model.prefill(
                self._cparams, tokens, self.capacity, cim=self.cim_prefill,
                **self._batch_inputs(len(reqs)))
        return greedy_sample(logits), state

    def _arrival_pump(self, clock, sleep, try_admit, busy, serve_round,
                      agree=None):
        """The arrival loop of trace serving, shared by every driver:
        sort the queue by (arrival_s, uid), offer arrived requests to
        ``try_admit(req, now)`` (False defers, e.g. no free slot), sleep
        to the next arrival when nothing is ``busy()``, otherwise run one
        ``serve_round(elapsed)``, which stamps ``latency_s`` as
        ``elapsed() - arrival_s`` (queue wait included).  ``agree(now)``
        makes the ranks of a mesh admit against one clock reading."""
        pending = sorted(self.queue, key=lambda r: (r.arrival_s, r.uid))
        self.queue = []
        t0 = clock()
        elapsed = lambda: clock() - t0     # noqa: E731
        while pending or busy():
            now = elapsed() if agree is None else agree(elapsed())
            while pending and pending[0].arrival_s <= now:
                if not try_admit(pending[0], now):
                    break
                pending.pop(0)
            if not busy():
                delay = pending[0].arrival_s - elapsed()
                if delay > 0:
                    sleep(delay)
                continue
            serve_round(elapsed)
        return self.completed


def device_decode_loop(decode, tok: torch.Tensor, state: dict,
                       max_new_row: torch.Tensor, eos_row: torch.Tensor,
                       max_new: int, width: int) -> torch.Tensor:
    """The bucket engine's on-device decode loop, from the prefill's
    sampled ``tok`` (rows,) and decode ``state``: ``max_new - 1`` steps
    of ``decode(tok, state) -> (logits, state)`` with no host sync.
    Returns (rows, width + 2) int32: each row's token buffer, its token
    count and the steps that had a live row."""
    dev = tok.device
    rows = tok.shape[0]
    buf = torch.zeros((rows, width), dtype=torch.int32, device=dev)
    buf[:, 0] = tok
    counts = torch.ones((rows,), dtype=torch.int32, device=dev)
    live = (counts < max_new_row) & (tok != eos_row)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    for step in range(max_new - 1):
        steps += live.any().to(torch.int32)
        logits, state = decode(tok, state)
        tok = greedy_sample(logits)
        buf[:, step + 1] = torch.where(live, tok, buf[:, step + 1])
        counts += live.to(torch.int32)
        live = live & (counts < max_new_row) & (tok != eos_row)
    return torch.cat([buf, counts[:, None], steps.expand(rows)[:, None]],
                     dim=1)


def chunk_loop(decode_step, tok: torch.Tensor, live: torch.Tensor,
               made: torch.Tensor, fresh: torch.Tensor,
               max_new_row: torch.Tensor, eos_row: torch.Tensor,
               chunk: int) -> tuple:
    """The schedulers' chunk on the device, with no host sync:
    ``chunk`` steps of ``decode_step(tok, live) -> tok`` over the pool's
    (local) slots.  Fresh slots emit their prefill token at buf[:, 0];
    live slots append at buf[slot, cnt[slot]].  Returns (buf (slots,
    chunk+1), cnt, steps, occ, tok, live, made): ``steps`` counts the
    steps that began with a live slot, ``occ`` the live slot-steps."""
    p, dev = tok.shape[0], tok.device
    buf = torch.zeros((p, chunk + 1), dtype=torch.int32, device=dev)
    buf[:, 0] = torch.where(fresh, tok, 0)
    cnt = fresh.to(torch.int32)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    occ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(chunk):
        steps += live.any().to(torch.int32)
        occ += live.sum(dtype=torch.int32)
        tok = decode_step(tok, live)
        at = cnt[:, None].long()
        buf.scatter_(1, at, torch.where(
            live, tok, buf.gather(1, at)[:, 0])[:, None])
        step = live.to(torch.int32)
        cnt = cnt + step
        made = made + step
        live = live & (made < max_new_row) & (tok != eos_row)
    return buf, cnt, steps, occ, tok, live, made


def round_buffer(buf, cnt, live, steps, occ, extras=(), split=None
                 ) -> torch.Tensor:
    """What a chunk's one transfer carries, per slot: the token buffer,
    the count, the live flag, the chunk's steps and occupancy and any
    fidelity extras, (slots, chunk + 5 + extras) int32; on a mesh every
    block's rows, all-gathered over the slot split.  Live slots stay live
    in a prefix of the chunk's steps, so the chunk's steps are the
    largest block's, its occupancy the blocks' sum."""
    p = buf.shape[0]
    return dist_rt.gather_split(torch.cat(
        [buf, cnt[:, None], live[:, None].to(torch.int32),
         steps.expand(p)[:, None], occ.expand(p)[:, None]]
        + [e.to(torch.int32).expand(p)[:, None] for e in extras], dim=1),
        split)


def slot_block(slots: int, split) -> tuple:
    """(local slots, first global slot) of this rank's block of a pool of
    ``slots`` slots split by the ``RowSplit`` ``split`` (or None)."""
    local = slots // dist_rt.split_count(split)
    return local, (split.index * local if split is not None else 0)


def stripe_pages(slots: int, local_slots: int, pages_per_slot: int,
                 num_pages: Optional[int] = None) -> tuple:
    """(num_pages, pages a stripe) of a paged pool whose slots split into
    ``slots // local_slots`` blocks, a stripe of pages each; by default
    every stripe holds its null page and each of its slots' pages."""
    blocks = slots // local_slots
    if num_pages is None:
        num_pages = blocks * (1 + local_slots * pages_per_slot)
    return num_pages, num_pages // blocks


def slot_decode_step(model, params, cim, pool: dict, pos: torch.Tensor,
                     tok: torch.Tensor) -> tuple:
    """One batched decode step of a dense slot pool, every slot at its
    own position: (sampled tokens, the new pool, the new positions)."""
    logits, state = model.decode(params, tok[:, None], dict(pool, pos=pos),
                                 cim=cim)
    return greedy_sample(logits), {k: state[k] for k in pool}, state["pos"]


def paged_decode_step(model, params, cim, attn_plan, pool, table,
                      pos: torch.Tensor, tok: torch.Tensor,
                      live: torch.Tensor) -> tuple:
    """One batched decode step of a paged pool through ``attn_plan``'s
    fused read (None: the gather read), the new K/V appended in place
    (dead slots write to the null page): (sampled tokens, the new
    positions)."""
    if attn_plan is not None:
        logits, kts, vts = model.decode_paged_fused(
            params, tok, pool, table, pos, cim=cim, attn_plan=attn_plan)
    else:
        logits, kts, vts = model.decode_paged(params, tok[:, None], pool,
                                              table, pos, cim=cim)
    paged_kv.append_tokens(pool, kts.transpose(0, 1), vts.transpose(0, 1),
                           table, pos, live)
    return greedy_sample(logits), pos + 1


class ServeEngine(_EngineBase):
    def __init__(self, model, params, capacity: int = 512,
                 max_batch: int = 8, cim=None, on_device_loop: bool = True,
                 device="cuda", extra_inputs=None, rules=None, mesh=None):
        super().__init__(model, params, capacity, cim, device, extra_inputs)
        self.max_batch = max_batch
        self.on_device_loop = on_device_loop
        if mesh is not None:
            if not on_device_loop or self.extra_inputs:
                raise NotImplementedError(
                    "on a mesh the bucket engine runs the on-device loop "
                    "without extra inputs (ROADMAP queue 1 item 8)")
            self._setup_mesh(rules, mesh, "the bucket engine")

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a bucket-wide tensor (as it is off-mesh)."""
        if self.mesh is None:
            return x
        return dist_rt.shard_rows(x, self._split)

    def _prefill(self, reqs: list[Request]):
        if self.mesh is None:
            return super()._prefill(reqs)
        tokens = self._rows(self._upload(torch.stack([
            torch.as_tensor(np.asarray(r.prompt), dtype=torch.int32)
            for r in reqs])))
        with self._meshed(self._split):
            logits, state = self.model.prefill(
                self._view, tokens, self.capacity, cim=self.cim_prefill)
        return greedy_sample(logits), state

    def _decode(self, tok: torch.Tensor, state: dict):
        with self._meshed(self._split):
            return self.model.decode(self._cparams, tok[:, None], state,
                                     cim=self.cim)

    def _next_bucket(self) -> list[Request]:
        """Pop up to max_batch queued requests sharing one prompt length."""
        if not self.queue:
            return []
        length = len(self.queue[0].prompt)
        batch, rest = [], []
        for r in self.queue:
            if len(batch) < self.max_batch and len(r.prompt) == length:
                batch.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return batch

    @staticmethod
    def buffer_width(max_new: int) -> int:
        """Token-buffer width: max_new rounded up to a power of two."""
        return 1 << max(max_new - 1, 0).bit_length()

    def _run_bucket_device(self, reqs: list[Request]):
        """Prefill, the on-device decode loop, and ONE host transfer."""
        b = len(reqs)
        max_new = max(r.max_new for r in reqs)
        width = self.buffer_width(max_new)
        # copied up before the prefill is queued, so the copies wait on
        # nothing
        if self.mesh is not None:
            self._split = dist_rt.batch_split(self.rules, self.mesh, b)
        max_new_row = self._rows(self._upload(torch.tensor(
            [r.max_new for r in reqs], dtype=torch.int32)))
        eos_row = self._rows(self._upload(torch.tensor(
            [r.eos_id for r in reqs], dtype=torch.int32)))
        tok, state = self._prefill(reqs)
        self.steps_run += 1
        out = device_decode_loop(self._decode, tok, state, max_new_row,
                                 eos_row, max_new, width)
        if self.mesh is not None:
            out = dist_rt.gather_split(out, self._split)
        out = self._device_get(out)
        # a rank's steps count its own rows; live rows stay live in a
        # prefix of the steps, so the bucket's count is the largest
        self.steps_run += int(out[:, -1].max())
        for r, row in zip(reqs, out):
            r.out_tokens.extend(int(t) for t in row[: int(row[width])])

    def _run_bucket_legacy(self, reqs: list[Request]):
        """Step-by-step loop: one host sync per decode step."""
        tok, state = self._prefill(reqs)
        self.steps_run += 1
        live = [True] * len(reqs)
        for i, (r, t) in enumerate(zip(reqs, self._device_get(tok))):
            r.out_tokens.append(int(t))
            if len(r.out_tokens) >= r.max_new or int(t) == r.eos_id:
                live[i] = False
        max_new = max(r.max_new for r in reqs)
        for _ in range(max_new - 1):
            if not any(live):
                break
            logits, state = self.model.decode(self.params, tok[:, None],
                                              state, cim=self.cim)
            tok = greedy_sample(logits)
            self.steps_run += 1
            for i, (r, t) in enumerate(zip(reqs, self._device_get(tok))):
                if not live[i]:
                    continue
                r.out_tokens.append(int(t))
                if len(r.out_tokens) >= r.max_new or int(t) == r.eos_id:
                    live[i] = False

    def run(self) -> list[Request]:
        """Serve the whole queue; returns completed requests.  Latency is
        the bucket's wall time, measured after a device sync."""
        run_bucket = (self._run_bucket_device if self.on_device_loop
                      else self._run_bucket_legacy)
        while self.queue:
            reqs = self._next_bucket()
            t0 = time.monotonic()
            run_bucket(reqs)
            dt = time.monotonic() - t0
            for r in reqs:
                r.done = True
                r.latency_s = dt
                self.completed.append(r)
        return self.completed

    def run_trace(self, clock=time.monotonic, sleep=time.sleep
                  ) -> list[Request]:
        """Replay arrival-stamped requests through the bucket driver (the
        shared ``_arrival_pump``): a request becomes visible at its
        ``arrival_s``, and each round serves ONE bucket of what has
        arrived, so arrivals join only at bucket boundaries."""
        run_bucket = (self._run_bucket_device if self.on_device_loop
                      else self._run_bucket_legacy)

        def admit(req, now):
            self.queue.append(req)
            return True

        def serve_round(elapsed):
            reqs = self._next_bucket()
            # a request waits until its bucket starts serving
            admit_t = elapsed()
            for r in reqs:
                r.admit_s = admit_t
            run_bucket(reqs)
            done_t = elapsed()
            for r in reqs:
                r.done = True
                r.latency_s = done_t - r.arrival_s
                self.completed.append(r)

        return self._arrival_pump(clock, sleep, admit,
                                  lambda: bool(self.queue), serve_round)


class Scheduler(_EngineBase):
    """Continuous-batching scheduler over a persistent slot pool.

    ``slots`` decode lanes live on the device across rounds.  The pool
    holds the model's decode state with the slot at dim 1 (a KV cache
    ``(L, slots, capacity, KV, hd)``, int8 scales, recurrent carries)
    and a ``(slots,)`` device position, so slots at different positions
    decode in one batched step (the reference vmaps a batch-1 decode
    over slots).  Each round
    runs one chunk of ``chunk`` decode steps and ONE device-to-host
    transfer, retires finished slots from it, and the arrival pump
    prefills arrived requests into freed slots before the next round.
    Admission is FIFO by ``arrival_s`` (then uid).  ``decode_steps``,
    ``steps_run`` and ``occupied_slot_steps`` equal the reference's on
    the same requests.

    The pump API (``free_slots`` / ``is_busy`` / ``try_admit`` /
    ``step_round``) lets a caller own the arrival loop.  Under a
    device-fidelity config the served weights drift per chunk and are
    restore-scrubbed every ``scrub_every`` chunks (``None`` or 0: never;
    see the module docstring).

    With ``rules=, mesh=`` the pool's slot dim is split over
    ``dist.sharding.slot_spmd_axes`` (replicated where ``slots`` does
    not divide): each rank holds ``local_slots`` slots, from global slot
    ``first_slot`` on, decodes them every step, and the chunk's token
    buffer and counts are all-gathered over the split before the
    chunk's one transfer, so ``host_transfers == chunks_run`` on every
    rank and the counts are the unmeshed ones.  A caller that owns the
    arrival loop on a mesh must offer every rank the same requests in
    the same order.
    """

    def __init__(self, model, params, capacity: int = 512, slots: int = 8,
                 chunk: int = 8, cim=None, clock=time.monotonic,
                 sleep=time.sleep, device="cuda",
                 scrub_every: Optional[int] = 8, extra_inputs=None,
                 rules=None, mesh=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        super().__init__(model, params, capacity, cim, device, extra_inputs)
        self.slots = slots
        self.chunk = chunk
        self._clock = clock
        self._sleep = sleep
        self._host_group = None
        self._prefill_all = False
        if mesh is not None:
            self._setup_mesh(rules, mesh, f"the {type(self).__name__}")
            self._split = dist_rt.batch_split(self.rules, mesh, slots,
                                              axis="slot")
            self._host_group = mesh_lib.host_group(mesh)
            # experts on a DP dim the slots split over: the owner's DP
            # group alone does not hold them, so every rank prefills
            self._prefill_all = self._split is not None and any(
                getattr(x, "ep", None) is not None
                and x.ep.dim in self._split.dims
                for x in tree.leaves(self._view))
        self.local_slots, self.first_slot = slot_block(slots, self._split)
        self._init_fidelity(scrub_every)
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        ls = self.local_slots
        # control lanes, shared by the dense and paged pools
        self.tok = torch.zeros((ls,), **i32)
        self.live = torch.zeros((ls,), dtype=torch.bool, device=dev)
        self.made = torch.zeros((ls,), **i32)
        self.fresh = torch.zeros((ls,), dtype=torch.bool, device=dev)
        self.max_new_row = torch.ones((ls,), **i32)
        self.eos_row = torch.full((ls,), -1, **i32)
        self.pos = torch.zeros((ls,), **i32)
        # host bookkeeping
        self._slot_req: list[Optional[Request]] = [None] * slots
        self.chunks_run = 0
        self.decode_steps = 0
        self.occupied_slot_steps = 0
        self._init_pool()

    def _init_pool(self) -> None:
        """The model's decode state for every slot: each leaf of
        ``init_cache`` but ``pos`` is a lane with the slot at dim 1 (KV
        and, for int8, its scales; a recurrent model's carries; the
        cross keys and values of the frames or patches)."""
        cache = self.model.init_cache(self.local_slots, self.capacity,
                                      self.device)
        self.pool = {k: v for k, v in cache.items() if k != "pos"}

    def owns(self, slot: int) -> bool:
        """Whether global slot ``slot`` is in this rank's block."""
        return self.first_slot <= slot < self.first_slot + self.local_slots

    def _prefills(self, slot: int) -> bool:
        """Whether this rank runs the prefill of an admission to
        ``slot``."""
        return self._prefill_all or self.owns(slot)

    # --------------------------------------------------- device fidelity

    def _init_fidelity(self, scrub_every: Optional[int]) -> None:
        """Graceful-degradation state for device-fidelity serving: the
        pristine (TL-ReRAM) weights and the SERVED weights, which the
        campaign's drift channel disturbs every chunk and a restore-scrub
        repairs every ``scrub_every`` chunks (the paper's DC-power-free
        restore as an online repair).  The served weights come up through
        one restore pass from the pristine ones (power-on)."""
        self.scrub_every = scrub_every
        self.scrubs_run = 0
        self.adc_clip_lo = 0          # ADC clip counters, summed per chunk
        self.adc_clip_hi = 0
        self._fault_serving = (self.cim is not None
                               and self.cim.mode == "ternary"
                               and self.cim.fidelity == "device")
        if not self._fault_serving:
            return
        fm = faults.get_fault_model()
        self._fault_model = fm
        self._params_pristine = self.params
        self._drift_key = fm.key_for("serve-drift")
        self._scrub_key = fm.key_for("serve-scrub")
        self.params = self._restore(self.scrubs_run)

    def _restore(self, n: int):
        """The pristine weights through the restore channel, keyed by
        the scrub count ``n``."""
        return faults.scrub_packed_params(
            self._params_pristine, self._fault_model.restore_yield,
            prng.fold_in(self._scrub_key, n), num_trits=self.cim.num_trits)

    def _pre_chunk(self) -> None:
        """Between-chunk drift: the disturb channel compounds on the
        served weights (a chunk-indexed key: a deterministic campaign)."""
        if self._fault_serving and self._fault_model.drift_rate > 0.0:
            self.params = faults.disturb_packed_params(
                self.params, self._fault_model.drift_rate,
                prng.fold_in(self._drift_key, self.chunks_run),
                num_trits=self.cim.num_trits)

    def _round_extras(self) -> tuple:
        """Device scalars for the round's ONE transfer: the ADC probe's
        (clip_lo, clip_hi) over the served weights; () when exact."""
        if self._fault_serving:
            return faults.adc_probe(self.params,
                                    adc_bits=self.cim.adc_bits,
                                    num_trits=self.cim.num_trits)
        return ()

    def _absorb_round_extras(self, extras) -> None:
        if len(extras):
            lo, hi = extras
            self.adc_clip_lo += int(lo)
            self.adc_clip_hi += int(hi)

    def _maybe_scrub(self) -> None:
        """Every ``scrub_every`` chunks, restore the served weights from
        the pristine tree: drift discarded, residual error bounded by
        the restore yield."""
        if (self._fault_serving and self.scrub_every
                and self.chunks_run % self.scrub_every == 0):
            self.scrubs_run += 1
            self.params = self._restore(self.scrubs_run)

    def kv_bytes(self) -> int:
        """Device bytes of the pool, every lane counted: a recurrent
        model's carries and the cross keys and values too (the
        reference counts k/v and their scales only).  The dense pool is
        always fully resident: every slot holds its full capacity."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())

    def kv_bytes_resident(self) -> int:
        return self.kv_bytes()

    def _arm_slot(self, slot: int, req: Request, tok0: torch.Tensor,
                  pos: int) -> None:
        """Arm a local slot's control lanes for a freshly prefilled
        request, on the device (tok0 is emitted by the next chunk's
        prologue).  The initial-liveness rule is the bucket loop's: tok0
        is token 1.  The host's values go up in one non-blocking upload:
        a Python scalar written into a device tensor is a blocking
        copy."""
        made, max_new, eos, at = self._upload(torch.tensor(
            [1, req.max_new, req.eos_id, pos], dtype=torch.int32))
        self.tok[slot] = tok0[0]
        self.made[slot] = made
        self.live[slot] = (tok0[0] != eos) & (max_new > 1)
        self.fresh[slot] = made > 0
        self.max_new_row[slot] = max_new
        self.eos_row[slot] = eos
        self.pos[slot] = at

    def _admit(self, req: Request, slot: int) -> bool:
        """Prefill one request and overwrite slot `slot` of the pool with
        its state: the whole slot, so nothing of the last occupant
        remains (on a mesh, on the ranks that hold the slot)."""
        if self._prefills(slot):
            tok0, st = self._prefill([req])
            if self.owns(slot):
                at = slot - self.first_slot
                for name, lane in self.pool.items():
                    lane[:, at] = st[name][:, 0]
                self._arm_slot(at, req, tok0, len(req.prompt))
        self.steps_run += 1
        self._slot_req[slot] = req
        return True

    @property
    def decode_per_slot(self) -> bool:
        """Whether the reference decodes this pool one slot per call (it
        vmaps a one-slot decode over the dense pool): the exact cim plans
        and the device MAC then take each slot's row as its own call,
        with its own input scale (and, for the device MAC, a one-row
        call's ADC noise; ``kernels.plan.rows_as_calls``)."""
        return True

    def _decode_step(self, tok: torch.Tensor, live: torch.Tensor
                     ) -> torch.Tensor:
        """One batched decode step of every local slot at its own
        position; returns the sampled tokens (local slots,)."""
        tok, self.pool, self.pos = slot_decode_step(
            self.model, self._cparams, self.cim, self.pool, self.pos, tok)
        return tok

    def _run_chunk(self) -> tuple:
        """Advance the local slots one chunk on the device, with no host
        sync (:func:`chunk_loop`); returns (buf (local slots, chunk+1),
        cnt, steps, occ) device tensors."""
        with rows_as_calls(self.decode_per_slot), self._meshed(self._split):
            (buf, cnt, steps, occ, self.tok, self.live,
             self.made) = chunk_loop(self._decode_step, self.tok, self.live,
                                     self.made, self.fresh,
                                     self.max_new_row, self.eos_row,
                                     self.chunk)
        return buf, cnt, steps, occ

    def _retire_slot(self, slot: int) -> None:
        """Host bookkeeping when a slot's request completes (the paged
        scheduler also returns the slot's pages)."""
        self._slot_req[slot] = None

    def _serve_round(self, elapsed) -> None:
        """One scheduling round: the drift hook, one chunk on the device,
        then ONE transfer carrying the tokens, counts, live mask, steps,
        occupancy and any fidelity extras (the ADC clip counters), then
        the scrub hook."""
        occupied = [i for i, r in enumerate(self._slot_req)
                    if r is not None]
        self._pre_chunk()
        buf, cnt, steps, occ = self._run_chunk()
        self.fresh = torch.zeros_like(self.fresh)
        p, c = self.local_slots, self.chunk + 1
        out = self._device_get(round_buffer(
            buf, cnt, self.live, steps, occ, self._round_extras(),
            self._split))
        self._absorb_round_extras(out[0, c + 4:])
        self.chunks_run += 1
        steps_run = int(out[::p, c + 2].max())
        self.decode_steps += steps_run
        self.steps_run += steps_run
        self.occupied_slot_steps += int(out[::p, c + 3].sum())
        done_t = elapsed()
        for s in occupied:
            req = self._slot_req[s]
            req.out_tokens.extend(int(t) for t in out[s, : int(out[s, c])])
            if not out[s, c + 1]:             # retire: the slot is free
                req.done = True               # for the next admission
                req.latency_s = done_t - req.arrival_s
                self.completed.append(req)
                self._retire_slot(s)
        self._maybe_scrub()

    # ---------------------------------------------------- external pump

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def is_busy(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def try_admit(self, req: Request, now: float = 0.0) -> bool:
        """Offer one request to the first free slot; False defers it (no
        free slot, or, paged, its pages cannot be reserved yet).  Stamps
        ``admit_s`` on success."""
        free = self.free_slots()
        if not free:
            return False
        if not self._admit(req, free[0]):
            return False
        req.admit_s = now
        return True

    def step_round(self, elapsed) -> None:
        """Run ONE scheduling round (one chunk, exactly one transfer);
        ``elapsed()`` is the caller's serve clock."""
        self._serve_round(elapsed)

    def run(self) -> list[Request]:
        """Serve the whole queue continuously through the shared arrival
        pump; returns completed requests.  On a mesh the ranks admit
        against the latest of their clock readings."""
        agree = None
        if self._host_group is not None:
            def agree(now):
                return mesh_lib.agree_max(now, self._host_group)
        return self._arrival_pump(self._clock, self._sleep, self.try_admit,
                                  self.is_busy, self._serve_round, agree)

    @property
    def slot_occupancy(self) -> float:
        """Fraction of (slot x decode-step) cells that held a live
        request."""
        total = self.slots * self.decode_steps
        return self.occupied_slot_steps / total if total else 0.0


class PagedScheduler(Scheduler):
    """Continuous batching over a paged, prefix-shared KV page pool.

    The scheduling semantics and the one-transfer-per-chunk contract are
    the :class:`Scheduler`'s, but resident KV scales with the tokens
    held, not ``slots x capacity``:

      * the device pool holds ``num_pages`` pages shared by all slots;
        a host page table maps each slot's positions onto pages, and is
        uploaded again only after admission or retire edits it;
      * admission reserves every page a request can touch (prompt plus
        its decode budget) all-or-nothing, so a request that does not
        fit is deferred (FIFO) rather than failing mid-decode;
      * full prompt pages whose token prefix already resides in the pool
        are mapped shared (refcounted, read-only) instead of written
        again (always: the reference's ``share_prefix=False`` is not
        ported);
      * retiring a slot drops its references; a page returns to the free
        list with its last reference.

    A ternary CIM config is re-resolved with ``kv_layout='paged'``.
    ``capacity`` bounds one request's prompt plus budget (rounded up to a
    page multiple); ``num_pages`` defaults to the dense-pool equivalent.

    ``fused_attn`` selects the decode read.  ``'auto'`` (the default)
    and ``True`` both resolve an ``op='attention'`` plan for the pool's
    device and read the pages through it: the ``paged_attn`` kernel on
    the card, its plain version on the CPU.  Under MoE routing ``'auto'``
    declines it and logs why, as the reference does: top-k routing turns
    the fused read's f32 round-off into other experts at a router
    near-tie, and the gather graph is the one whose tokens equal the
    dense pool's; ``True`` still takes it (one routing group over every
    slot, as the reference's unvmapped fused read).  An int8-KV pool
    has scale pages the kernel does not read: ``'auto'`` logs that and
    serves through the gather path, ``True`` raises, as in the
    reference.  The reference's other reasons to decline (interpret
    mode, sharded pools) do not arise here.  ``False`` names the
    ``slot_view`` gather path, and the scheduler logs that it was named.
    A windowed model is refused (its rolling cache does not page), and
    so are the VLM and the encoder-decoder (their cross keys and values
    are per-slot state the page pool does not hold), as in the
    reference.

    On a mesh (``rules=, mesh=``) the read is the gather path: ``'auto'``
    resolves to it and ``True`` raises, as the reference does for its
    spmd-sharded slot pool.  Where the slots split over the DP axes the
    page pool is striped over the same ranks (the ``page`` rule): each
    rank holds ``num_pages / blocks`` pages (default: one null page and
    every local slot's worth), with its own null page, allocator and
    prefix registry, and a slot takes pages from its owner's stripe.  A
    prompt page is therefore shared only between slots of one stripe.
    ``pages_in_use_peak``, ``kv_bytes_resident_peak`` and
    ``prefix_hit_rate`` are summed over the stripes;
    :meth:`stripe_stats` gives each stripe's.
    """

    def __init__(self, model, params, capacity: int = 512, slots: int = 8,
                 chunk: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None, cim=None,
                 clock=time.monotonic, sleep=time.sleep,
                 fused_attn="auto", device="cuda",
                 scrub_every: Optional[int] = 8, extra_inputs=None,
                 rules=None, mesh=None):
        if not model.supports_paged_kv:
            raise ValueError(f"{type(model).__name__} (family "
                             f"{model.cfg.family!r}) does not support "
                             f"paged KV; use the dense-pool Scheduler")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if fused_attn not in (True, False, "auto"):
            raise ValueError(f"fused_attn must be True, False or 'auto', "
                             f"got {fused_attn!r}")
        capacity = -(-capacity // page_size) * page_size
        self.page_size = page_size
        self.pages_per_slot = capacity // page_size
        self.num_pages = num_pages
        self.fused_attn = fused_attn
        if cim is not None:
            cim = dataclasses.replace(cim, kv_layout="paged")
        super().__init__(model, params, capacity=capacity, slots=slots,
                         chunk=chunk, cim=cim, clock=clock, sleep=sleep,
                         device=device, scrub_every=scrub_every,
                         extra_inputs=extra_inputs, rules=rules, mesh=mesh)

    def _resolve_attn_plan(self):
        """The attention plan for this pool's geometry and device, or
        None for the named gather path.  The plan shape is the problem
        the chunk loop runs each step: every slot's grouped queries
        (``S*KV*rep`` rows) of head dim ``hd`` against the per-slot page
        capacity ``W*page_size``."""
        if self.fused_attn is False:
            _LOG.info("PagedScheduler: fused_attn=False names the "
                      "slot_view gather path")
            return None
        from ..kernels import plan_matmul
        cfg = self.model.cfg
        if self.mesh is not None:
            why = "spmd-sharded slot pool"
            if self.fused_attn is True:
                raise ValueError(f"fused_attn=True but the fused "
                                 f"paged-attention read is unavailable: "
                                 f"{why}")
            _LOG.info("PagedScheduler: fused paged-attention read "
                      "unavailable (%s); serving through the slot_view "
                      "gather path", why)
            return None
        if cfg.kv_cache_dtype == "int8":
            why = ("int8 KV pool (scale pages the fused read does not "
                   "consume)")
            if self.fused_attn is True:
                raise ValueError(f"fused_attn=True but the fused "
                                 f"paged-attention read is unavailable: "
                                 f"{why}")
            _LOG.info("PagedScheduler: fused paged-attention read "
                      "unavailable (%s); serving through the slot_view "
                      "gather path", why)
            return None
        if cfg.num_experts and self.fused_attn == "auto":
            _LOG.info("PagedScheduler: fused paged-attention read "
                      "declined under MoE routing (top-k amplifies f32 "
                      "round-off; token parity with the dense pool needs "
                      "the gather graph); serving through the slot_view "
                      "gather path")
            return None
        shape = (self.slots * cfg.num_heads, cfg.hd,
                 self.pages_per_slot * self.page_size)
        try:
            return plan_matmul(shape, platform=self.device.type,
                               op="attention", domain="float",
                               kv_layout="paged")
        except ValueError as e:
            raise ValueError(f"fused_attn={self.fused_attn!r} but no "
                             f"backend reads the paged pool: {e}") from e

    def _init_pool(self) -> None:
        self.attn_plan = self._resolve_attn_plan()
        blocks = self.slots // self.local_slots
        self.num_pages, self.stripe_pages = stripe_pages(
            self.slots, self.local_slots, self.pages_per_slot,
            self.num_pages)
        if blocks > 1:
            axes = shd.slot_spmd_axes(self.rules, self.mesh, self.slots)
            if (self.num_pages % blocks or shd.page_spmd_axes(
                    self.rules, self.mesh, self.num_pages) != axes):
                raise ValueError(
                    f"num_pages={self.num_pages} must stripe over the DP "
                    f"axes {axes} the {self.slots} slots split over (a "
                    f"multiple of {blocks} that the 'page' rule folds "
                    f"over them)")
        self.pool = paged_kv.init_page_pool(self.model.cfg,
                                            self.stripe_pages,
                                            self.page_size, self.device)
        # one allocator per stripe, each on every rank: the host
        # scheduler's decisions are the same everywhere
        self.allocators = [paged_kv.PageAllocator(self.stripe_pages,
                                                  self.page_size)
                           for _ in range(blocks)]
        # host page tables (stripe-local page ids); entries past a slot's
        # reservation stay 0 (its stripe's null page, masked by position)
        self._page_table = np.zeros((self.slots, self.pages_per_slot),
                                    np.int32)
        self._page_table_dev = None
        self._slot_pages: list[list] = [[] for _ in range(self.slots)]

    @property
    def allocator(self) -> paged_kv.PageAllocator:
        """The pool's one allocator; a pool striped over a mesh has one
        a stripe (``allocators``), and its counts are the engine's
        (``pages_in_use_peak``, ``prefix_hit_rate``)."""
        if len(self.allocators) != 1:
            raise ValueError(f"the pool has {len(self.allocators)} "
                             f"stripes, one allocator each: read "
                             f"allocators or the engine's counts")
        return self.allocators[0]

    def _allocator_of(self, slot: int) -> paged_kv.PageAllocator:
        return self.allocators[slot // self.local_slots]

    # ------------------------------------------------------- accounting

    def kv_bytes(self) -> int:
        """Allocated device bytes of the page pool (this rank's
        stripe)."""
        return self.pool.nbytes

    def kv_bytes_resident(self) -> int:
        """Bytes of the pages currently holding live KV, every stripe."""
        return self.pages_in_use * self.pool.page_bytes

    @property
    def pages_in_use(self) -> int:
        return sum(a.pages_in_use for a in self.allocators)

    @property
    def pages_in_use_peak(self) -> int:
        """Each stripe's peak of pages in use, summed."""
        return sum(a.peak_in_use for a in self.allocators)

    @property
    def kv_bytes_resident_peak(self) -> int:
        return self.pages_in_use_peak * self.pool.page_bytes

    @property
    def prefix_hit_rate(self) -> float:
        """Prefix hits over lookups, every stripe."""
        lookups = sum(a.prefix_lookups for a in self.allocators)
        hits = sum(a.prefix_hits for a in self.allocators)
        return hits / lookups if lookups else 0.0

    def stripe_stats(self) -> list:
        """Per stripe (a DP rank's pages; one stripe off a mesh): its
        pages-in-use peak, resident-KV peak and prefix hit rate."""
        return [dict(pages_in_use_peak=a.peak_in_use,
                     kv_bytes_resident_peak=(a.peak_in_use
                                             * self.pool.page_bytes),
                     prefix_hits=a.prefix_hits,
                     prefix_lookups=a.prefix_lookups,
                     prefix_hit_rate=a.prefix_hit_rate)
                for a in self.allocators]

    # -------------------------------------------------------- admission

    def _admit(self, req: Request, slot: int) -> bool:
        ps = self.page_size
        s_len = len(req.prompt)
        # positions written: 0..S-1 (prefill) and S..S+max_new-2 (decode
        # feeds tok0 first; the last sampled token is never fed)
        last_pos = s_len + req.max_new - 2 if req.max_new >= 2 else \
            s_len - 1
        n_total = last_pos // ps + 1
        if n_total > self.pages_per_slot:
            raise ValueError(
                f"request uid={req.uid} needs {n_total} pages (prompt "
                f"{s_len} + max_new {req.max_new}) but capacity "
                f"{self.capacity} holds {self.pages_per_slot} per slot")
        if n_total > self.stripe_pages - 1:
            # deferring would spin forever: even an empty pool cannot
            # satisfy this reservation
            raise ValueError(
                f"request uid={req.uid} needs {n_total} pages but the pool "
                f"holds {self.stripe_pages - 1} usable pages (num_pages="
                f"{self.num_pages}, page 0 of each of "
                f"{len(self.allocators)} stripes reserved); size num_pages "
                f"to cover one worst-case request")
        alloc = self._allocator_of(slot)
        prompt_np = np.asarray(req.prompt, dtype=np.int32)
        n_share = s_len // ps                  # full prompt pages
        pages: list = [None] * n_total
        keys = [paged_kv.prefix_key(prompt_np, j, ps)
                for j in range(n_share)]
        shared = []
        for j, key in enumerate(keys):
            pid = alloc.lookup_prefix(key)
            if pid is not None:
                pages[j] = pid
                shared.append(j)
        missing = [j for j in range(n_total) if pages[j] is None]
        fresh_ids = alloc.alloc(len(missing))
        if fresh_ids is None:
            # pool exhausted: roll back the prefix references and their
            # statistics (the deferred retry looks them up again)
            alloc.release([pages[j] for j in shared])
            alloc.prefix_hits -= len(shared)
            alloc.prefix_lookups -= n_share
            return False
        for j, pid in zip(missing, fresh_ids):
            pages[j] = pid
            if j < n_share:
                alloc.register_prefix(keys[j], pid)
        if self._prefills(slot):
            tok0, st = self._prefill([req])
        self.steps_run += 1
        if self.owns(slot):
            hit = set(shared)
            write_src = [j for j in range(-(-s_len // ps)) if j not in hit]
            if write_src:
                paged_kv.write_prompt_pages(
                    self.pool, st,
                    self._upload(torch.tensor(
                        [pages[j] for j in write_src], dtype=torch.int32)),
                    self._upload(torch.tensor(write_src,
                                              dtype=torch.int32)))
            self._arm_slot(slot - self.first_slot, req, tok0, s_len)
        self._page_table[slot] = 0
        self._page_table[slot, :n_total] = pages
        self._page_table_dev = None
        self._slot_pages[slot] = pages
        self._slot_req[slot] = req
        return True

    # ------------------------------------------------------ chunk round

    def _upload_page_table(self) -> None:
        """Copy the host page table to the device if an admission or a
        retire edited it since the last upload."""
        if self._page_table_dev is None:
            first = self.first_slot
            self._page_table_dev = self._upload(torch.from_numpy(
                self._page_table[first:first + self.local_slots].copy()))

    @property
    def decode_per_slot(self) -> bool:
        """The reference's gather read vmaps a one-slot decode; its fused
        read is one call over every slot."""
        return self.attn_plan is None

    def _decode_step(self, tok: torch.Tensor, live: torch.Tensor
                     ) -> torch.Tensor:
        tok, self.pos = paged_decode_step(
            self.model, self._cparams, self.cim, self.attn_plan, self.pool,
            self._page_table_dev, self.pos, tok, live)
        return tok

    def _run_chunk(self) -> tuple:
        self._upload_page_table()
        return super()._run_chunk()

    def _retire_slot(self, slot: int) -> None:
        self._allocator_of(slot).release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._page_table[slot] = 0
        self._page_table_dev = None
        self._slot_req[slot] = None
