"""SNR/bandwidth channel: upload latency against a round deadline.

The port's copy of the JAX package's ``env/bandwidth.py`` (numpy only).
Per round each selected client draws an uplink rate from a log-normal
distribution (``bw_mean_mbps`` median, ``bw_sigma`` log-std, the usual
shadow-fading model); uploading the ``bw_upload_mbits`` model update,
scaled by the comm plane's ``wire_fraction``, takes ``latency = bits /
rate`` seconds. A round closes after ``bw_deadline_s`` seconds, so an
upload that needs r deadlines arrives with ``r - 1`` rounds of
staleness:

    delayed = latency > deadline
    delay   = clip(ceil(latency / deadline) - 1, 1, max_delay)
"""
from __future__ import annotations

import numpy as np

from repro_torch import comm
from repro_torch.env.base import ChannelModel, Environment, register
from repro_torch.env.virtual import TAG_DELAY, TAG_DELAY_LEN, hash_u01


class BandwidthChannel(ChannelModel):
    def draw(self, t, selected, rng):
        fl = self.fl
        m = len(selected)
        if fl.max_delay <= 0:
            return self._no_delays(m)
        rate = fl.bw_mean_mbps * np.exp(fl.bw_sigma * rng.randn(m))
        return self._delays_from_rate(rate)

    def _delays_from_rate(self, rate):
        fl = self.fl
        # the bits on the wire: the comm plane's compression ratio scales
        # the upload (exactly 1.0 for comm_plane="none")
        upload = fl.bw_upload_mbits * comm.wire_fraction(fl)
        latency = upload / np.maximum(rate, 1e-9)
        deadlines = np.ceil(latency / fl.bw_deadline_s).astype(np.int64)
        delayed = deadlines > 1
        delays = np.clip(deadlines - 1, 1, fl.max_delay).astype(np.int32)
        delays = np.where(delayed, delays, 1).astype(np.int32)
        return delayed, delays

    def draw_batch(self, t0, selected):
        """Virtual path: shadow-fading normals for the whole block via
        Box-Muller over two hashed uniforms keyed on (t, client)."""
        fl = self.fl
        n, m = selected.shape
        if fl.max_delay <= 0:
            return np.zeros((n, m), bool), np.ones((n, m), np.int32)
        t = np.arange(t0, t0 + n, dtype=np.int64)[:, None]
        u1 = hash_u01(fl.seed, TAG_DELAY, t, selected)
        u2 = hash_u01(fl.seed, TAG_DELAY_LEN, t, selected)
        z = np.sqrt(-2.0 * np.log(np.maximum(u1, 1e-12))) \
            * np.cos(2.0 * np.pi * u2)
        return self._delays_from_rate(fl.bw_mean_mbps
                                      * np.exp(fl.bw_sigma * z))


@register
class BandwidthEnvironment(Environment):
    name = "bandwidth"
    aliases = ("snr",)

    def _make_channel(self, fl):
        return BandwidthChannel(fl)
