"""The always-on request loop: bounded admission, same-kind K-lane
coalescing, deadline-or-batch-full draining.

Counterpart of ``repro.serve.loop``.

Requests enter a bounded admission queue (reject — don't buffer unboundedly —
when the service is behind; the caller sees backpressure) and are coalesced
per kind: traversal kinds drain as soon as K same-kind queries are waiting
(one lane batch answers all of them in a single edge-stream pass per
iteration), or when the OLDEST waiting query has aged past the deadline
(``max_wait_ms``) — a partial batch is then padded to K by repeating its
last root (``admission_batches`` rule: duplicate lanes are cheap and keep
every batch at one width). The other kinds (neighbors, recommend) use the
same queue/deadline machinery with their own batch cap.

Delta events ride the same stream: ``ingest`` stages insertions and the loop
flushes when the buffer crosses its auto-flush threshold (or on an explicit
flush event), re-tiling only dirty buckets and swapping the resident
partition between batches — never mid-batch, so every query is answered
against one consistent snapshot.

The loop is synchronous and replay-driven (``run(events)``): real wall-clock
timestamps, deterministic order. Per-query latency = completion time minus
arrival at ``submit`` — it includes time spent waiting for the batch to fill,
which is what a caller actually experiences.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

from repro_torch.serve.metrics import BatchRecord, FlushRecord, ServingMetrics
from repro_torch.serve.router import GraphService, Query, TRAVERSAL_KINDS

__all__ = ["LoopConfig", "Completion", "RequestLoop"]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    queue_capacity: int = 256  # total waiting queries before rejects
    max_wait_ms: float = 20.0  # deadline: oldest waiting query age to drain
    host_batch: int = 16  # batch cap for the other kinds (neighbors/recommend)


@dataclasses.dataclass(frozen=True)
class Completion:
    qid: int
    kind: str
    answer: object
    latency_ms: float


class RequestLoop:
    """Drives a ``GraphService`` from a request/ingest event stream."""

    def __init__(self, service: GraphService, cfg: LoopConfig = LoopConfig()):
        self.service = service
        self.cfg = cfg
        self._queues: dict = {}  # kind -> deque[(Query, arrival_s)]
        self.metrics = ServingMetrics()

    # -- admission ---------------------------------------------------------
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, query: Query, now: Optional[float] = None) -> bool:
        """Admit a query; False = rejected (queue full — backpressure)."""
        if self.queued >= self.cfg.queue_capacity:
            self.metrics.record_rejected()
            return False
        self._queues.setdefault(query.kind, deque()).append(
            (query, now if now is not None else time.perf_counter())
        )
        return True

    def ingest(self, src, dst, weights=None):
        """Stage edge insertions; flush if the buffer crossed its threshold."""
        self.service.ingest(src, dst, weights)
        if self.service.delta.should_flush():
            self.flush()

    def flush(self):
        rec = self.service.flush()
        if rec.edges_added:
            self.metrics.record_flush(rec)
        return rec

    # -- draining ----------------------------------------------------------
    def _batch_width(self, kind: str) -> int:
        return self.service.lanes if kind in TRAVERSAL_KINDS else self.cfg.host_batch

    def pump(self, now: Optional[float] = None, force: bool = False) -> list:
        """Drain every due batch: full batches always; aged (or ``force``d)
        partial batches too. Returns the completions."""
        completions = []
        deadline_s = self.cfg.max_wait_ms / 1e3
        for kind in list(self._queues):
            dq = self._queues[kind]
            width = self._batch_width(kind)
            while dq:
                if len(dq) < width:
                    t = now if now is not None else time.perf_counter()
                    if not force and (t - dq[0][1]) < deadline_s:
                        break  # young partial batch: keep waiting
                entries = [dq.popleft() for _ in range(min(width, len(dq)))]
                completions.extend(self._execute(kind, entries))
        return completions

    def _execute(self, kind: str, entries: list) -> list:
        res = self.service.answer_batch([q for q, _ in entries])
        done = time.perf_counter()
        self.metrics.record_batch(BatchRecord(
            kind=kind, served=res.served, lanes=res.lanes, wall_s=res.wall_s,
            iterations=res.iterations, edges=self.service.g.num_edges,
            cold=res.cold,
        ))
        out = []
        for (q, arrival), ans in zip(entries, res.answers):
            lat_ms = (done - arrival) * 1e3
            self.metrics.record_query(kind, lat_ms)
            out.append(Completion(qid=q.qid, kind=kind, answer=ans, latency_ms=lat_ms))
        return out

    # -- replay ------------------------------------------------------------
    def run(self, events: list) -> list:
        """Replay an event stream and return all completions in completion
        order. Events:

          ("query", Query)                   submit + drain due batches
          ("delta", (src, dst[, weights]))   stage insertions (may auto-flush)
          ("flush", None)                    explicit flush

        A final forced pump drains the trailing partial batches, and a final
        flush applies any staged-but-unflushed insertions."""
        self.metrics.start()
        completions = []
        for ev, payload in events:
            if ev == "query":
                if self.submit(payload):
                    completions.extend(self.pump())
            elif ev == "delta":
                self.ingest(*payload)
            elif ev == "flush":
                self.flush()
            else:
                raise ValueError(f"unknown event {ev!r}")
        completions.extend(self.pump(force=True))
        if self.service.delta.pending_edges:
            self.flush()
        self.metrics.stop()
        return completions
