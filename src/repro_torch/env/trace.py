"""Trace replay: drive rounds from a recorded schedule (.npz) instead of
a generative channel — testbed logs, deployment traces, or the synthetic
mobility trace below. The trace loops modulo its length, so any run
horizon replays it.

``.npz`` layout (all arrays (T, m)): ``selected`` int, ``limited`` bool,
``delayed`` bool, ``delays`` int (1 where on time); optional
``data_sizes`` float. ``save_trace`` writes any ``batch()`` output in
this layout, so every environment can be frozen into a replayable trace
(record once, sweep algorithms against the identical rounds).

With ``trace_path=""`` the environment synthesizes a MOBILITY trace:
each client moves through coverage on its own period/phase; it is
selectable only while in coverage, and uploads near the cell edge are
delayed proportionally to signal deficit — availability and staleness
become temporally correlated per client, which no i.i.d. draw models.

The port's copy of the JAX package's ``env/trace.py`` (numpy only): an
``.npz`` written by either package's ``save_trace`` replays in the other
unchanged, and the synthetic trace is bitwise the JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.env.base import (Environment, FixedTierProfile,
                                  RoundSchedule, register, round_rng,
                                  side_rng)

TRACE_KEYS = ("selected", "limited", "delayed", "delays")


def save_trace(path: str, trace: dict[str, np.ndarray]) -> None:
    """Persist a stacked schedule (any ``Environment.batch`` output)."""
    missing = [k for k in TRACE_KEYS if k not in trace]
    assert not missing, f"trace missing arrays: {missing}"
    np.savez(path, **trace)


def synth_mobility_trace(fl: FLConfig,
                         rounds: int | None = None) -> dict[str, np.ndarray]:
    """Deterministic synthetic mobility trace (pure function of fl).

    Client i's signal is ``sin(2*pi*t / period_i + phase_i)`` plus
    per-round shadowing noise; the m strongest-signal clients
    participate (coverage-gated availability), and weak-signal uploads
    among them arrive late (delay grows with signal deficit).
    """
    T = rounds if rounds is not None else max(fl.rounds, 64)
    K, m = fl.num_clients, fl.clients_per_round
    assert m <= K, (m, K)
    geo = side_rng(fl, -7)  # static geometry stream (off the round axis)
    period = geo.uniform(20.0, 80.0, K)
    phase = geo.uniform(0.0, 2 * np.pi, K)
    profile = FixedTierProfile(fl)
    rows = {k: [] for k in TRACE_KEYS}
    for t in range(T):
        rng = round_rng(fl, t)
        sig = (np.sin(2 * np.pi * t / period + phase)
               + 0.15 * rng.randn(K))
        sel = np.argsort(-sig)[:m].astype(np.int32)
        s = sig[sel]
        if fl.max_delay > 0:
            delayed = s < 0.25
            frac = np.clip((0.25 - s) / 1.25, 0.0, 1.0)
            delays = np.clip(np.ceil(frac * fl.max_delay), 1,
                             fl.max_delay).astype(np.int32)
            delays = np.where(delayed, delays, 1).astype(np.int32)
        else:
            delayed = np.zeros(m, bool)
            delays = np.ones(m, np.int32)
        rows["selected"].append(sel)
        rows["limited"].append(profile.limited(sel))
        rows["delayed"].append(delayed)
        rows["delays"].append(delays)
    return {k: np.stack(v) for k, v in rows.items()}


@register
class TraceEnvironment(Environment):
    name = "trace"
    aliases = ("mobility",)
    # a trace IS a materialised population — (T, m) arrays on disk and
    # an O(K) synthesis loop — so it stays dense at any K
    supports_virtual = False

    def __init__(self, fl: FLConfig, data_sizes=None):
        super().__init__(fl, data_sizes)
        if fl.trace_path:
            with np.load(fl.trace_path) as npz:
                self._trace = {k: np.asarray(npz[k]) for k in TRACE_KEYS}
                self._trace_sizes = (np.asarray(npz["data_sizes"])
                                     if "data_sizes" in npz.files else None)
        else:
            self._trace = synth_mobility_trace(fl)
            self._trace_sizes = None
        sel = self._trace["selected"]
        assert sel.ndim == 2 and sel.shape[1] == fl.clients_per_round, \
            f"trace is (T, m)={sel.shape}, config m={fl.clients_per_round}"
        assert sel.max() < fl.num_clients, \
            f"trace selects client {sel.max()} >= num_clients={fl.num_clients}"
        for k in TRACE_KEYS[1:]:
            assert self._trace[k].shape == sel.shape, (k,
                                                       self._trace[k].shape)
        # delays beyond the config's staleness cap would wrap the async
        # ring buffer (Q = max_delay + 1 slots) into the wrong rounds
        delays, delayed = self._trace["delays"], self._trace["delayed"]
        assert delays.min() >= 1 and delays.max() <= max(fl.max_delay, 1), \
            (f"trace delays in [{delays.min()}, {delays.max()}] exceed "
             f"config max_delay={fl.max_delay}; replay with a config whose "
             f"max_delay covers the recording")
        assert (delays[~delayed.astype(bool)] == 1).all(), \
            "trace has delays != 1 on on-time uploads"

    def _make_channel(self, fl):
        return None  # the trace IS the channel

    def round(self, t: int) -> RoundSchedule:
        r = t % len(self._trace["selected"])
        sel = self._trace["selected"][r].astype(np.int32)
        if self.devices.has_sizes:
            sizes = self.devices.sizes(sel)
        elif self._trace_sizes is not None:
            sizes = self._trace_sizes[r].astype(np.float32)
        else:
            sizes = np.ones(len(sel), np.float32)
        return RoundSchedule(sel,
                             self._trace["limited"][r].astype(bool),
                             self._trace["delayed"][r].astype(bool),
                             self._trace["delays"][r].astype(np.int32),
                             sizes)
