"""Continuous-batching scheduler: FIFO admission under a token budget
(the port's copy of the JAX package's ``serve/scheduler.py``; pure
Python, the same policy and counters).

The engine calls ``try_admit`` between decode steps with the resources
it currently has free (a decode slot, KV blocks); the scheduler only
ever offers the HEAD of the queue — no request can be overtaken, so no
request starves (gated in tests/test_torch_serve.py). The token budget
bounds the total in-flight footprint sum(prompt_len + max_new) the way
a real deployment bounds KV memory.

Invariant counters (``admitted_order``, ``peak_inflight_tokens``,
``slot_history``) exist for the tests and the serving telemetry rows —
they are not consulted by the policy itself.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class Request:
    """One decode request. ``prompt`` is a plain list/1-D array of int
    token ids (per-request length — nothing is padded here)."""
    rid: int
    prompt: list
    max_new: int
    # engine-filled runtime state / timings (seconds, perf_counter span)
    generated: list = field(default_factory=list)
    submit_t: float = 0.0
    admit_t: float = 0.0
    done_t: float = 0.0
    prefill_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def tokens(self) -> int:
        """Token-budget footprint: full prompt + full generation."""
        return self.prompt_len + self.max_new


class Scheduler:
    """FIFO queue + token-budget admission policy."""

    def __init__(self, max_batch_tokens: int = 0):
        self.max_batch_tokens = int(max_batch_tokens)   # 0 = unbounded
        self.queue: deque[Request] = deque()
        self.inflight: dict[int, Request] = {}
        self.inflight_tokens = 0
        # invariant counters (tests / telemetry)
        self.submitted_order: list[int] = []
        self.admitted_order: list[int] = []
        self.peak_inflight_tokens = 0
        self.slot_history: dict[int, list[int]] = {}

    def submit(self, req: Request) -> None:
        self.submitted_order.append(req.rid)
        self.queue.append(req)

    def try_admit(self, *, can_place) -> Request | None:
        """Admit the queue head iff the engine can place it (free slot +
        blocks, ``can_place(req)``) and it fits the token budget.
        Returns the admitted request or None."""
        if not self.queue:
            return None
        req = self.queue[0]
        if (self.max_batch_tokens
                and self.inflight_tokens + req.tokens > self.max_batch_tokens
                and self.inflight):      # never wedge an oversized head
            return None
        if not can_place(req):
            return None
        self.queue.popleft()
        self.inflight[req.rid] = req
        self.inflight_tokens += req.tokens
        self.admitted_order.append(req.rid)
        self.peak_inflight_tokens = max(self.peak_inflight_tokens,
                                        self.inflight_tokens)
        return req

    def record_slot(self, rid: int, slot: int) -> None:
        self.slot_history.setdefault(slot, []).append(rid)

    def release(self, req: Request) -> None:
        self.inflight.pop(req.rid)
        self.inflight_tokens -= req.tokens

    @property
    def pending(self) -> int:
        return len(self.queue)
