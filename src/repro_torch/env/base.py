"""The Environment interface and the name-keyed environment registry.

The port's copy of the JAX package's ``env/base.py`` (numpy only). An
``Environment`` composes participation (which m of K clients take part
in round t), a device profile (FES limited-ness, data sizes) and a
channel model (per-client upload delays), and emits the stacked
``{selected, limited, delayed, delays, data_sizes}`` arrays the round
engine consumes via ``batch(t0, n_rounds)``.

THE CONTRACT: ``batch(t0, n)`` row ``i`` is BIT-IDENTICAL to
``round(t0 + i)``, and both are bit-identical to the JAX package's
environment for the same config. Round t's schedule is a pure function
of (config, t): per-round RNG streams are keyed on the absolute round
index, and stateful channels (Markov chains) memoize a state trajectory
that is itself a pure function of (seed, t), so chunked and per-round
execution see the same schedule.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.env.virtual import (DENSE_SELECT_MAX, TAG_LIMITED,
                                     floyd_sample, hash_u01, is_virtual,
                                     select_batch_hashed)


@dataclass
class RoundSchedule:
    """One round's environment draw (the schedule contract)."""

    selected: np.ndarray     # (m,) int32 client indices
    limited: np.ndarray      # (m,) bool — computing-limited (FES) clients
    delayed: np.ndarray      # (m,) bool — upload delayed
    delays: np.ndarray       # (m,) int32 in [1, max_delay] (1 where on time)
    data_sizes: np.ndarray   # (m,) float32 — |D_i| aggregation weights


def round_rng(fl: FLConfig, t: int) -> np.random.RandomState:
    """The per-round schedule RNG stream (seed algorithm, unchanged):
    each round owns an independent stream keyed on its absolute index."""
    return np.random.RandomState((fl.seed * 1_000_003 + t) % 2**32)


def side_rng(fl: FLConfig, t: int) -> np.random.RandomState:
    """A second per-round stream (channel-state chains, trace synthesis)
    that cannot collide with ``round_rng`` draws for the same round."""
    return np.random.RandomState(
        (fl.seed * 1_000_003 + t + 0x9E3779B9) % 2**32)


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------
class Participation:
    """Which clients take part in round t. ``select`` draws from the
    round's shared RNG stream FIRST (before the channel), preserving the
    seed's draw order."""

    def __init__(self, fl: FLConfig):
        self.fl = fl

    def select(self, t: int, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError


class UniformParticipation(Participation):
    """m of K uniformly without replacement (paper §V).

    ``rng.choice(K, m, replace=False)`` materialises an O(K) permutation
    per round; beyond ``DENSE_SELECT_MAX`` clients an O(m) Floyd draw
    from the SAME per-round stream takes over. The guard keeps the draw
    sequence (and the bernoulli env's bit-identity net) untouched at
    paper scale."""

    def select(self, t, rng):
        K, m = self.fl.num_clients, self.fl.clients_per_round
        if K <= DENSE_SELECT_MAX:
            return rng.choice(K, size=m, replace=False).astype(np.int32)
        return floyd_sample(rng, K, m)


class DeviceProfile:
    """Per-client static device facts: compute tier, FES limited-ness,
    local-step budget, dataset size (aggregation weight)."""

    def __init__(self, fl: FLConfig, data_sizes=None):
        self.fl = fl
        self.has_sizes = data_sizes is not None
        # data_sizes is a dense (K,) array OR a callable mapping a
        # client-id array to sizes (a virtual population never holds K
        # floats; VirtualClientShards.client_sizes is the usual source)
        self._sizes_fn = data_sizes if callable(data_sizes) else None
        self._sizes = (None if data_sizes is None or callable(data_sizes)
                       else np.asarray(data_sizes, np.float32))

    def limited(self, selected: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def tier(self, selected: np.ndarray) -> np.ndarray:
        """Compute tier per selected client (0 = limited, 1 = full)."""
        return np.where(self.limited(selected), 0, 1).astype(np.int32)

    def step_budget(self, n_steps: int, selected: np.ndarray) -> np.ndarray:
        """Local-step budget per selected client: limited devices afford
        only a ``fedprox_partial`` fraction of the full step count
        (shape-generic: a whole (n_rounds, m) block at once)."""
        full = np.full(np.shape(selected), n_steps, np.int32)
        part = np.maximum(1, (n_steps * self.fl.fedprox_partial)).astype(
            np.int32)
        return np.where(self.limited(selected), part, full)

    def sizes(self, selected: np.ndarray) -> np.ndarray:
        if self._sizes_fn is not None:
            return np.asarray(self._sizes_fn(selected), np.float32)
        if self._sizes is None:
            return np.ones(np.shape(selected), np.float32)
        return self._sizes[selected].astype(np.float32)


class FixedTierProfile(DeviceProfile):
    """The paper's setting: a FIXED subset of devices (ratio p_limited,
    drawn once from the seed) *is* computing-limited."""

    def __init__(self, fl: FLConfig, data_sizes=None):
        super().__init__(fl, data_sizes)
        rng = np.random.RandomState(fl.seed)
        k = int(round(fl.p_limited * fl.num_clients))
        self.limited_set = set(
            rng.choice(fl.num_clients, size=k, replace=False).tolist())

    def limited(self, selected):
        return np.array([i in self.limited_set for i in selected])


class VirtualTierProfile(DeviceProfile):
    """K-free tier profile: limited-ness is a per-client hashed
    Bernoulli(p_limited) coin, evaluated only for selected clients.
    Population-level limited count is Binomial(K, p) rather than the
    dense profile's exact round(p*K) — equal in expectation, and the
    dense profile stays in force below ``VIRTUAL_K_MIN``. Shape-generic,
    so a whole (n_rounds, m) block evaluates at once.
    """

    def limited(self, selected):
        return hash_u01(self.fl.seed, TAG_LIMITED,
                        np.asarray(selected)) < self.fl.p_limited


class ChannelModel:
    """Per-client upload delay for round t. ``draw`` consumes the
    round's shared RNG stream AFTER participation, preserving the seed's
    draw order; stateful channels key any extra streams on the absolute
    round index (``side_rng``) so purity in t survives."""

    def __init__(self, fl: FLConfig):
        self.fl = fl

    def draw(self, t: int, selected: np.ndarray,
             rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
        """-> (delayed (m,) bool, delays (m,) int32 in [1, max_delay])."""
        raise NotImplementedError

    def _no_delays(self, m: int) -> tuple[np.ndarray, np.ndarray]:
        return np.zeros(m, bool), np.ones(m, np.int32)

    def draw_batch(self, t0: int, selected: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Virtual-path draw for a stacked (n_rounds, m) cohort block.

        Default: one ``draw`` per row against a FRESH per-round stream.
        Hashed selection consumes no RNG, so the stream starts at
        position 0 (a different stream universe from the dense path,
        which is the point of the ``is_virtual`` guard); still pure in t
        per row. Channels with vectorised hashed draws override this."""
        rows = [self.draw(t0 + i, selected[i], round_rng(self.fl, t0 + i))
                for i in range(len(selected))]
        return (np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]))


# ---------------------------------------------------------------------------
# the environment = participation x devices x channel
# ---------------------------------------------------------------------------
class Environment:
    """Base environment: composes the three components with the shared
    per-round RNG stream. Subclasses usually only override
    ``_make_channel``; trace replay overrides ``round`` wholesale."""

    #: registry key; aliases are extra names resolving to the same class
    name: str = ""
    aliases: tuple[str, ...] = ()
    #: environments that inherently materialise the population (trace
    #: replay) opt out of the virtual path and stay dense at any K
    supports_virtual: bool = True

    def __init__(self, fl: FLConfig, data_sizes=None):
        self.fl = fl
        self.virtual = is_virtual(fl) and self.supports_virtual
        self.participation = self._make_participation(fl)
        self.devices = (VirtualTierProfile(fl, data_sizes) if self.virtual
                        else self._make_devices(fl, data_sizes))
        self.channel = self._make_channel(fl)

    # component factories ------------------------------------------------
    def _make_participation(self, fl) -> Participation:
        return UniformParticipation(fl)

    def _make_devices(self, fl, data_sizes) -> DeviceProfile:
        return FixedTierProfile(fl, data_sizes)

    def _make_channel(self, fl) -> ChannelModel:
        raise NotImplementedError

    # the schedule contract ----------------------------------------------
    def round(self, t: int) -> RoundSchedule:
        """Round t's schedule — a pure function of (config, t)."""
        if self.virtual:
            b = self._vbatch(t, 1)
            return RoundSchedule(b["selected"][0], b["limited"][0],
                                 b["delayed"][0], b["delays"][0],
                                 b["data_sizes"][0])
        rng = round_rng(self.fl, t)
        sel = self.participation.select(t, rng)
        limited = self.devices.limited(sel)
        delayed, delays = self.channel.draw(t, sel, rng)
        return RoundSchedule(sel, limited, delayed, delays,
                             self.devices.sizes(sel))

    def batch(self, t0: int, n_rounds: int) -> dict[str, np.ndarray]:
        """Stacked (n_rounds, m) schedule arrays for the fused scan
        engine. Row i is BIT-IDENTICAL to ``round(t0 + i)`` — see the
        module docstring. Virtual populations evaluate the whole block
        in vectorised hashed draws (O(n*m), no per-round Python work);
        the dense path keeps the sequential per-round RandomState draws
        that define bit-identity at paper scale."""
        if self.virtual:
            return self._vbatch(t0, n_rounds)
        m = self.fl.clients_per_round
        out = {"selected": np.empty((n_rounds, m), np.int32),
               "limited": np.empty((n_rounds, m), bool),
               "delayed": np.empty((n_rounds, m), bool),
               "delays": np.empty((n_rounds, m), np.int32),
               "data_sizes": np.empty((n_rounds, m), np.float32)}
        for i in range(n_rounds):
            r = self.round(t0 + i)
            out["selected"][i] = r.selected
            out["limited"][i] = r.limited
            out["delayed"][i] = r.delayed
            out["delays"][i] = r.delays
            out["data_sizes"][i] = r.data_sizes
        return out

    def _vbatch(self, t0: int, n_rounds: int) -> dict[str, np.ndarray]:
        """The virtual-population block: selection, tier and channel are
        pure hashed functions of (client_id, seed, t), evaluated for the
        whole (n_rounds, m) block elementwise — nothing here scales with
        K. Both ``round`` and ``batch`` route through this when virtual,
        so the batch-row contract holds by construction."""
        sel = select_batch_hashed(self.fl, t0, n_rounds)
        delayed, delays = self.channel.draw_batch(t0, sel)
        return {"selected": sel,
                "limited": self.devices.limited(sel),
                "delayed": delayed,
                "delays": delays.astype(np.int32),
                "data_sizes": self.devices.sizes(sel)}


# ---------------------------------------------------------------------------
# registry (mirrors core.strategies)
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, type[Environment]] = {}


def register(cls: type[Environment]) -> type[Environment]:
    """Class decorator: file-local registration under name + aliases."""
    assert cls.name, cls
    for key in (cls.name,) + tuple(cls.aliases):
        assert key not in _REGISTRY or _REGISTRY[key] is cls, key
        _REGISTRY[key] = cls
    return cls


def names() -> list[str]:
    """All registered environment names (aliases included), sorted."""
    return sorted(_REGISTRY)


def get(name: str) -> type[Environment]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown environment {name!r}; "
                       f"registered: {names()}") from None


def resolve(fl: FLConfig,
            data_sizes: np.ndarray | None = None) -> Environment:
    """Instantiate the environment for a config (``fl.env``)."""
    return get(fl.env)(fl, data_sizes=data_sizes)
