"""Gilbert–Elliott bursty fading channel (two-state Markov, per client).

Each client's link sits in a Good or Bad state; per round it flips
Good->Bad with prob ``ge_p_gb`` and Bad->Good with prob ``ge_p_bg``.
Bad links delay uploads with high probability and draw LONG delays
(upper half of {1..max_delay}); good links rarely delay and draw short
ones — the bursty, temporally-correlated outages the i.i.d. Bernoulli
model cannot express (the realism gap named by arXiv:2307.10616).

Purity in t (the batch/round contract): the state trajectory over ALL K
clients is advanced with one ``side_rng(fl, s)`` stream per round s, so
the state at round t is a pure function of (seed, t) — independent of
which rounds were queried, in what order, or how they were batched. The
trajectory is memoized, so sequential sweeps stay O(1) per round; it
holds (t + 1) x K bools, which the dense path (K up to
``VIRTUAL_K_MIN``) affords. A virtual population keeps no (K,) state:
each selected client advances its own hashed chain.

The port's copy of the JAX package's ``env/gilbert_elliott.py`` (numpy
only): the same draws in the same order, so schedules are bitwise the
JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.env.base import ChannelModel, Environment, register, side_rng
from repro_torch.env.virtual import TAG_DELAY, TAG_DELAY_LEN, TAG_GE, hash_u01


class GilbertElliottChannel(ChannelModel):
    def __init__(self, fl):
        super().__init__(fl)
        self._bad: list[np.ndarray] = []   # memoized state trajectory
        self._vmemo: dict[int, tuple[int, bool]] = {}  # virtual chains

    def _state(self, t: int) -> np.ndarray:
        """(K,) bool — Bad-state flags at round t (pure in (seed, t))."""
        fl = self.fl
        if not self._bad:
            # round 0: draw from the chain's stationary distribution
            p_bad = fl.ge_p_gb / max(fl.ge_p_gb + fl.ge_p_bg, 1e-9)
            self._bad.append(
                side_rng(fl, 0).rand(fl.num_clients) < p_bad)
        while len(self._bad) <= t:
            s = len(self._bad)
            u = side_rng(fl, s).rand(fl.num_clients)
            prev = self._bad[s - 1]
            self._bad.append(
                np.where(prev, u >= fl.ge_p_bg, u < fl.ge_p_gb))
        return self._bad[t]

    def draw(self, t, selected, rng):
        fl = self.fl
        m = len(selected)
        if fl.max_delay <= 0:
            return self._no_delays(m)
        bad = self._state(t)[selected]
        p = np.where(bad, fl.ge_p_delay_bad, fl.ge_p_delay_good)
        delayed = rng.rand(m) < p
        short = rng.randint(1, max(1, fl.max_delay // 3) + 1, size=m)
        long_ = rng.randint(max(1, (fl.max_delay + 1) // 2),
                            fl.max_delay + 1, size=m)
        delays = np.where(bad, long_, short).astype(np.int32)
        delays = np.where(delayed, delays, 1).astype(np.int32)
        return delayed, delays

    # virtual path: per-CLIENT hashed chains, no (K,) trajectory -------
    def _p_stationary(self) -> float:
        fl = self.fl
        return fl.ge_p_gb / max(fl.ge_p_gb + fl.ge_p_bg, 1e-9)

    def _bad_client(self, t: int, c: int) -> bool:
        """Client c's Bad flag at round t from its own hashed chain —
        a Markov state has no closed form, so the chain is advanced
        step-by-step but memoized per client: sequential sweeps cost
        O(delta_t) per selected client, not O(t) and never O(K)."""
        fl = self.fl
        s, st = self._vmemo.get(c, (-1, False))
        if s < 0 or s > t:
            st = bool(hash_u01(fl.seed, TAG_GE, 0, c) < self._p_stationary())
            s = 0
        while s < t:
            s += 1
            u = float(hash_u01(fl.seed, TAG_GE, s, c))
            st = (u >= fl.ge_p_bg) if st else (u < fl.ge_p_gb)
        self._vmemo[c] = (s, st)
        return st

    def draw_batch(self, t0, selected):
        fl = self.fl
        n, m = selected.shape
        if fl.max_delay <= 0:
            return np.zeros((n, m), bool), np.ones((n, m), np.int32)
        bad = np.array([[self._bad_client(t0 + i, int(c))
                         for c in selected[i]] for i in range(n)])
        t = np.arange(t0, t0 + n, dtype=np.int64)[:, None]
        p = np.where(bad, fl.ge_p_delay_bad, fl.ge_p_delay_good)
        delayed = hash_u01(fl.seed, TAG_DELAY, t, selected) < p
        u = hash_u01(fl.seed, TAG_DELAY_LEN, t, selected)
        short_hi = max(1, fl.max_delay // 3)
        long_lo = max(1, (fl.max_delay + 1) // 2)
        short = 1 + (u * short_hi).astype(np.int64)           # U{1..hi}
        long_ = long_lo + (u * (fl.max_delay + 1 - long_lo)).astype(
            np.int64)                                         # U{lo..max}
        delays = np.where(bad, long_, short)
        delays = np.where(delayed, delays, 1).astype(np.int32)
        return delayed, delays


@register
class GilbertElliottEnvironment(Environment):
    name = "gilbert_elliott"
    aliases = ("ge", "bursty")

    def _make_channel(self, fl):
        return GilbertElliottChannel(fl)
