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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import resolve_device


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                      # (S,) int token ids
    max_new: int = 16
    eos_id: int = -1                 # -1: never
    arrival_s: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0
    admit_s: float = 0.0


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

    def __init__(self, model, params, capacity: int, cim, device):
        self.model = model
        self.params = params
        self.capacity = capacity
        self.device = resolve_device(device)
        # resolve the plan request once, against the engine's platform,
        # so an incapable backend fails here and not mid-decode
        self.cim = None if cim is None else cim.resolve(self.device.type)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.steps_run = 0
        self.host_transfers = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _device_get(self, x: torch.Tensor) -> np.ndarray:
        """Every device-to-host sync goes through here (counted)."""
        self.host_transfers += 1
        return x.cpu().numpy()

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.out_tokens) for r in self.completed)

    def _prefill(self, reqs: list[Request]):
        tokens = torch.stack([torch.as_tensor(np.asarray(r.prompt),
                                              dtype=torch.int32)
                              for r in reqs]).to(self.device)
        logits, state = self.model.prefill(self.params, tokens,
                                           self.capacity, cim=self.cim)
        return greedy_sample(logits), state


class ServeEngine(_EngineBase):
    def __init__(self, model, params, capacity: int = 512,
                 max_batch: int = 8, cim=None, on_device_loop: bool = True,
                 device="cuda"):
        super().__init__(model, params, capacity, cim, device)
        self.max_batch = max_batch
        self.on_device_loop = on_device_loop

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
        dev = self.device
        b = len(reqs)
        max_new = max(r.max_new for r in reqs)
        width = self.buffer_width(max_new)
        # copied up before the prefill is queued, so the copies wait on
        # nothing
        max_new_row = torch.tensor([r.max_new for r in reqs],
                                   dtype=torch.int32, device=dev)
        eos_row = torch.tensor([r.eos_id for r in reqs], dtype=torch.int32,
                               device=dev)
        tok, state = self._prefill(reqs)
        self.steps_run += 1
        buf = torch.zeros((b, width), dtype=torch.int32, device=dev)
        buf[:, 0] = tok
        counts = torch.ones((b,), dtype=torch.int32, device=dev)
        live = (counts < max_new_row) & (tok != eos_row)
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        for step in range(max_new - 1):
            steps += live.any().to(torch.int32)
            logits, state = self.model.decode(self.params, tok[:, None],
                                              state, cim=self.cim)
            tok = greedy_sample(logits)
            buf[:, step + 1] = torch.where(live, tok, buf[:, step + 1])
            counts += live.to(torch.int32)
            live = live & (counts < max_new_row) & (tok != eos_row)
        out = self._device_get(torch.cat(
            [buf, counts[:, None], steps.expand(b)[:, None]], dim=1))
        self.steps_run += int(out[0, -1])
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
