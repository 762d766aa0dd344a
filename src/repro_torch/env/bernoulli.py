"""The i.i.d. Bernoulli-delay environment (paper §V settings).

Uploads are independently delayed with probability ``p_delay`` each
round; the delay is uniform on {1..max_delay}. The draw order is the
JAX package's, so schedules are bit-identical to ``repro.env``'s.
"""
from __future__ import annotations

import numpy as np

from repro_torch.env.base import ChannelModel, Environment, register
from repro_torch.env.virtual import TAG_DELAY, TAG_DELAY_LEN, hash_u01


class BernoulliChannel(ChannelModel):
    """Delayed ~ Bernoulli(p_delay), delay ~ U{1..max_delay}, i.i.d."""

    def draw(self, t, selected, rng):
        fl = self.fl
        m = len(selected)
        if fl.max_delay > 0 and fl.p_delay > 0:
            delayed = rng.rand(m) < fl.p_delay
            delays = rng.randint(1, fl.max_delay + 1,
                                 size=m).astype(np.int32)
        else:
            delayed = np.zeros(m, bool)
            delays = np.ones(m, np.int32)
        delays = np.where(delayed, delays, 1).astype(np.int32)
        return delayed, delays

    def draw_batch(self, t0, selected):
        """Virtual path: the whole (n_rounds, m) block in two hashed
        draws keyed on (t, client) — i.i.d. across both, like the dense
        channel, with no per-round Python work."""
        fl = self.fl
        n, m = selected.shape
        if fl.max_delay <= 0 or fl.p_delay <= 0:
            return np.zeros((n, m), bool), np.ones((n, m), np.int32)
        t = np.arange(t0, t0 + n, dtype=np.int64)[:, None]
        delayed = hash_u01(fl.seed, TAG_DELAY, t, selected) < fl.p_delay
        delays = 1 + (hash_u01(fl.seed, TAG_DELAY_LEN, t, selected)
                      * fl.max_delay).astype(np.int64)  # U{1..max_delay}
        delays = np.where(delayed, delays, 1).astype(np.int32)
        return delayed, delays


@register
class BernoulliEnvironment(Environment):
    name = "bernoulli"
    aliases = ("iid_delay",)

    def _make_channel(self, fl):
        return BernoulliChannel(fl)
