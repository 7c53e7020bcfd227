"""Continuous-batching request scheduler: slot admission, eviction, and
per-request state (the port's own copy of ``repro.serve.scheduler``: the
port never imports the JAX package).

Pure Python bookkeeping, no tensors, so every decision is exactly
reproducible: FIFO by submission order with head-of-line arrival gating
(a queued request whose simulated ``arrival`` step is still in the future
blocks the queue, modelling an open-loop workload), admission into the
LOWEST free slot index, eviction the step a stop condition fires.  The
``events`` list is a complete audit trail; two runs over the same
submissions replay identical traces, and the port's trail equals the
reference's event for event.

Fault tolerance (all deterministic, all audited):

* **Queue TTL**: a queued request with ``queue_ttl`` set may wait at most
  that many engine steps past its ``arrival``; ``expire(now)`` sweeps the
  queue in FIFO order and evicts overdue entries with a typed
  ``("expire", rid, REASON_DEADLINE_EXPIRED, now)`` event.  The engine
  runs the sweep at the top of every step, BEFORE admission, so an
  expired request can never race into a slot.
* **Running deadline**: ``deadline_steps`` bounds how many engine steps
  a request may occupy a slot after admission (``admitted_at`` is stamped
  by ``admit``); the ENGINE enforces it (it owns the step counter) via
  ``release(..., reason=REASON_DEADLINE_EXPIRED)``.
* **Bounded retry-with-backoff**: when ``max_queue`` is set and the
  queue is full, a submission with retry budget left is *deferred*
  instead of rejected: it re-submits at ``now + backoff * 2**attempt``
  (exponential, deterministic), at most ``retries`` times, then rejects
  with ``REASON_OVER_BUDGET``.  ``poll_retries(now)`` moves due retries
  back through ``submit`` each engine step.

Typed reasons (``REASON_*``) make the audit trail machine-checkable: a
rejection/expiry/eviction event always says WHY.

The scheduler never touches the cache: ``serve.engine.ServingEngine``
pairs each admission/eviction with the matching ``serve.kvcache`` row
write, so scheduler state and slot contents move in lockstep.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass

# Typed audit reasons: every reject/expire/evict event carries one of
# these, so the audit trail (and its replay-determinism test) can assert
# WHY a request left the system, not just that it did.
REASON_OVER_BUDGET = "over_budget"
REASON_DEADLINE_EXPIRED = "deadline_expired"
REASON_QUARANTINED = "quarantined"
REASONS = (REASON_OVER_BUDGET, REASON_DEADLINE_EXPIRED, REASON_QUARANTINED)


@dataclass
class Request:
    """One generation request and its accumulated per-request state.

    ``tokens`` grows to at most ``max_new_tokens`` entries (the first is
    the prefill argmax, exactly like ``serve.engine.generate``'s first
    output column); generation also stops early when ``stop_token`` is
    emitted.  ``status`` walks queued -> running -> finished (or
    ``rejected`` when the request can never fit a slot, ``expired`` when
    its queue TTL lapses, ``evicted`` when the engine aborts it over
    budget or past its deadline, ``quarantined`` when its decode logits
    went non-finite, ``deferred`` while waiting out a retry backoff).

    Fault-tolerance knobs (``None``/``0`` = disabled, the default):
    ``deadline_steps`` caps engine steps in a slot after admission,
    ``queue_ttl`` caps engine steps waiting in the queue past ``arrival``,
    ``retries``/``backoff`` bound the queue-full resubmission policy.
    ``admitted_at``/``attempts`` are bookkeeping stamped by the scheduler.
    """
    rid: int
    prompt: tuple
    max_new_tokens: int
    arrival: int = 0
    stop_token: int | None = None
    status: str = "queued"
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    deadline_steps: int | None = None
    queue_ttl: int | None = None
    retries: int = 0
    backoff: int = 1
    attempts: int = 0
    admitted_at: int | None = None

    def done(self) -> bool:
        """Stop condition: token budget spent or stop token emitted."""
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.stop_token is not None and bool(self.tokens)
                and self.tokens[-1] == self.stop_token)


class Scheduler:
    """Slot allocator + FIFO queue for the continuous-batching engine.

    ``max_queue`` bounds the waiting line (``None`` = unbounded, the
    default): a submission against a full queue defers (bounded
    retry-with-backoff) or rejects with ``REASON_OVER_BUDGET``.
    """

    def __init__(self, n_slots: int, max_queue: int | None = None):
        self.n_slots = n_slots
        self.max_queue = max_queue
        self._slots: list = [None] * n_slots
        self._queue: deque = deque()
        self._retries: list = []      # (due_step, request), submission order
        self.events: list = []

    # -- queue side ---------------------------------------------------------

    def submit(self, req: Request, now: int = 0) -> str:
        """Enqueue a request (FIFO; callers submit in arrival order).

        Against a full queue (``max_queue`` set) the request is deferred
        with exponential backoff while it has ``retries`` budget left,
        else rejected with ``REASON_OVER_BUDGET``.  Returns the resulting
        ``req.status`` (``"queued"`` / ``"deferred"`` / ``"rejected"``).
        """
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            if req.attempts < req.retries:
                self.defer(req, now)
            else:
                self.reject(req, REASON_OVER_BUDGET)
            return req.status
        req.status = "queued"
        self._queue.append(req)
        self.events.append(("submit", req.rid, req.arrival))
        return req.status

    def reject(self, req: Request, reason: str) -> None:
        """Mark a request unservable (e.g. prompt beyond slot capacity)."""
        req.status = "rejected"
        self.events.append(("reject", req.rid, reason))

    def defer(self, req: Request, now: int) -> None:
        """Park a queue-full submission for one exponential-backoff window:
        attempt ``a`` re-submits at ``now + backoff * 2**a`` — bounded,
        deterministic, and audited as ``("defer", rid, attempt, due)``."""
        delay = max(1, req.backoff) * (2 ** req.attempts)
        req.attempts += 1
        req.status = "deferred"
        self._retries.append((now + delay, req))
        self.events.append(("defer", req.rid, req.attempts, now + delay))

    def poll_retries(self, now: int) -> list:
        """Re-submit every deferred request whose backoff window has
        elapsed (``due <= now``), in original deferral order — each goes
        back through ``submit`` and may queue, defer again, or exhaust
        its budget and reject.  Returns the requests that rejected (the
        engine counts them)."""
        due = [(d, r) for d, r in self._retries if d <= now]
        if not due:
            return []
        self._retries = [(d, r) for d, r in self._retries if d > now]
        rejected = []
        for _, req in due:
            self.events.append(("retry", req.rid, req.attempts, now))
            if self.submit(req, now) == "rejected":
                rejected.append(req)
        return rejected

    def expire(self, now: int) -> list:
        """Sweep the queue for requests whose ``queue_ttl`` has lapsed
        (waited more than ``queue_ttl`` steps past ``arrival``); each is
        evicted in FIFO order with a typed audit event.  Returns the
        expired requests (the engine counts them)."""
        expired = []
        kept: deque = deque()
        for req in self._queue:
            if (req.queue_ttl is not None
                    and now - req.arrival > req.queue_ttl):
                req.status = "expired"
                self.events.append(
                    ("expire", req.rid, REASON_DEADLINE_EXPIRED, now))
                expired.append(req)
            else:
                kept.append(req)
        self._queue = kept
        return expired

    # -- slot side ----------------------------------------------------------

    def admit(self, now: int):
        """Admit the queue head into the lowest free slot, if both exist
        and the head has arrived (``arrival <= now``).  Returns
        ``(slot, request)`` or ``None``; loop until ``None`` to refill
        every free slot in one engine step.  Stamps ``admitted_at`` — the
        reference point for the engine's ``deadline_steps`` sweep."""
        free = next((i for i, r in enumerate(self._slots) if r is None),
                    None)
        if free is None or not self._queue:
            return None
        if self._queue[0].arrival > now:
            return None
        req = self._queue.popleft()
        req.status, req.slot = "running", free
        req.admitted_at = now
        self._slots[free] = req
        self.events.append(("admit", req.rid, free, now))
        return free, req

    def release(self, req: Request, status: str = "finished",
                reason: str | None = None) -> None:
        """Free a running request's slot and record why.  ``reason`` (a
        ``REASON_*`` tag) extends the audit event for fault evictions —
        deadline expiry, numerical quarantine — and is omitted from the
        event for plain finishes."""
        self._slots[req.slot] = None
        if reason is None:
            self.events.append((status, req.rid, req.slot))
        else:
            self.events.append((status, req.rid, req.slot, reason))
        req.status, req.slot = status, None

    # -- queries ------------------------------------------------------------

    def active(self):
        """Occupied slots as ``[(slot, request), ...]`` in slot order."""
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def has_work(self) -> bool:
        """True while anything is queued (even future arrivals), parked
        for retry, or live in a slot."""
        return (bool(self._queue) or bool(self._retries)
                or any(r is not None for r in self._slots))

    def queued(self) -> int:
        """Number of requests still waiting in the queue."""
        return len(self._queue)
