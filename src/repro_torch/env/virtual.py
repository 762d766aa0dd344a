"""Hashed counter-based draws for populations beyond paper scale.

The port's copy of the JAX package's ``env/virtual.py`` (numpy only):
splitmix64 over (seed, tag, counters...), the O(m) Floyd draw that
replaces ``rng.choice`` above ``DENSE_SELECT_MAX`` clients, the
vectorised hashed cohort sampler and ``VirtualPopulation`` (K clients
that exist only as hash and arithmetic functions of (client_id, seed)).
``is_virtual(fl)`` is True when ``fl.population == "virtual"`` or, under
``"auto"``, when K exceeds ``VIRTUAL_K_MIN``; below that every draw
stays the dense RandomState algorithm. Either way schedules equal the
JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import FLConfig

#: dense UniformParticipation keeps the seed's ``rng.choice`` draw (and
#: therefore bit-identity with the paper-scale reference) up to this K;
#: above it the O(m) Floyd sampler takes over
DENSE_SELECT_MAX = 4096

#: ``population="auto"`` switches the whole environment to the virtual
#: (hashed) population above this K
VIRTUAL_K_MIN = 65536

# stream tags: one independent hashed stream per schedule component
TAG_SELECT = 0x53454C  # participation rejection sampler
TAG_LIMITED = 0x4C494D  # per-client limited-ness coin
TAG_DELAY = 0x44454C  # bernoulli channel: delayed coin
TAG_DELAY_LEN = 0x444C4E  # bernoulli channel: delay length
TAG_GE = 0x47455354  # gilbert-elliott per-client state chain


def is_virtual(fl: FLConfig) -> bool:
    """Does this config run the hashed (K-free) population machinery?"""
    mode = getattr(fl, "population", "auto")
    if mode == "dense":
        return False
    if mode == "virtual":
        return True
    if mode != "auto":
        raise ValueError(f"unknown population mode {mode!r}; "
                         "expected 'auto' | 'dense' | 'virtual'")
    return fl.num_clients > VIRTUAL_K_MIN


# ---------------------------------------------------------------------------
# counter-based hashing (splitmix64): stateless per-(tag, counters) draws
# ---------------------------------------------------------------------------
_U64 = np.uint64
_GOLDEN = _U64(0x9E3779B97F4A7C15)
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> _U64(30))) * _MIX1
        z = (z ^ (z >> _U64(27))) * _MIX2
        return z ^ (z >> _U64(31))


def hash_bits(seed: int, tag: int, *counters) -> np.ndarray:
    """Vectorised 64-bit hash of (seed, tag, counters...); the counters
    broadcast against each other like any numpy operands."""
    h = _splitmix64(np.asarray(int(seed) & 0xFFFFFFFFFFFFFFFF, _U64)
                    ^ _U64(int(tag) & 0xFFFFFFFFFFFFFFFF))
    for c in counters:
        c = np.asarray(c)
        with np.errstate(over="ignore"):
            h = _splitmix64(h ^ c.astype(_U64))
    return h


def hash_u01(seed: int, tag: int, *counters) -> np.ndarray:
    """Uniform [0, 1) float64 draws from the hashed stream (53-bit)."""
    return (hash_bits(seed, tag, *counters) >> _U64(11)) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# O(m) without-replacement sampling
# ---------------------------------------------------------------------------
def floyd_sample(rng: np.random.RandomState, K: int, m: int) -> np.ndarray:
    """Floyd's classic O(m) uniform without-replacement draw of m of K,
    consuming m ``randint`` draws from ``rng`` (no O(K) permutation).
    Returned order is the insertion order (deterministic given rng)."""
    assert 0 < m <= K, (m, K)
    chosen: dict[int, None] = {}        # insertion-ordered set
    for j in range(K - m, K):
        t = int(rng.randint(0, j + 1))
        chosen[j if t in chosen else t] = None
    return np.fromiter(chosen, np.int32, count=m)


def _row_dup_mask(sel: np.ndarray) -> np.ndarray:
    """(n, m) bool: True where an entry repeats an EARLIER entry of its
    row (the earliest occurrence of each value is kept)."""
    order = np.argsort(sel, axis=1, kind="stable")
    s = np.take_along_axis(sel, order, axis=1)
    eq = np.zeros_like(s, bool)
    eq[:, 1:] = s[:, 1:] == s[:, :-1]
    out = np.zeros_like(eq)
    np.put_along_axis(out, order, eq, axis=1)
    return out


def select_batch_hashed(fl: FLConfig, t0: int, n: int) -> np.ndarray:
    """(n, m) int32 cohort matrix for rounds t0..t0+n-1, drawn without
    replacement per round from the hashed stream — O(n*m) expected,
    vectorised over the whole chunk, pure in t per row.

    Candidates are keyed on (t, slot, attempt); within-round duplicates
    are re-hashed with a bumped attempt counter (collision probability
    ~ m^2 / 2K per round, so a couple of passes suffice at virtual
    scale). The pathological tail falls back to the per-round Floyd
    draw, which is pure in t too.
    """
    K, m = fl.num_clients, fl.clients_per_round
    assert m <= K, (m, K)
    t = np.arange(t0, t0 + n, dtype=np.int64)[:, None]
    slot = np.arange(m, dtype=np.int64)[None, :]
    sel = np.minimum((hash_u01(fl.seed, TAG_SELECT, t, slot) * K), K - 1
                     ).astype(np.int64)
    for attempt in range(1, 32):
        dup = _row_dup_mask(sel)
        if not dup.any():
            break
        fresh = np.minimum(
            hash_u01(fl.seed, TAG_SELECT + attempt, t, slot) * K, K - 1
        ).astype(np.int64)
        sel = np.where(dup, fresh, sel)
    else:  # unreachable for m << K; stay pure in t regardless
        from repro_torch.env.base import round_rng
        for i in np.flatnonzero(_row_dup_mask(sel).any(axis=1)):
            sel[i] = floyd_sample(round_rng(fl, int(t0 + i)), K, m)
    return sel.astype(np.int32)


# ---------------------------------------------------------------------------
# the population as a pure function of (client_id, seed)
# ---------------------------------------------------------------------------
class VirtualPopulation:
    """K clients that exist only as hash/arithmetic functions.

    ``sizes_fn`` (optional) maps a client-id array to per-client data
    sizes (|D_i| aggregation weights); ``data.pipeline
    .VirtualClientShards.client_sizes`` is the arithmetic counterpart on
    the staging side; the default is weight 1. Every method takes
    client-id arrays of ANY shape and evaluates elementwise, so a whole
    (n_rounds, m) schedule block hashes in one vectorised call.
    """

    def __init__(self, fl: FLConfig, sizes_fn=None):
        self.fl = fl
        self.sizes_fn = sizes_fn

    def select_batch(self, t0: int, n: int) -> np.ndarray:
        return select_batch_hashed(self.fl, t0, n)

    def limited(self, selected: np.ndarray) -> np.ndarray:
        """Hashed Bernoulli(p_limited) coin per client: the virtual
        counterpart of ``FixedTierProfile``'s fixed membership set."""
        selected = np.asarray(selected)
        return (hash_u01(self.fl.seed, TAG_LIMITED, selected)
                < self.fl.p_limited)

    def tier(self, selected: np.ndarray) -> np.ndarray:
        return np.where(self.limited(selected), 0, 1).astype(np.int32)

    def sizes(self, selected: np.ndarray) -> np.ndarray:
        selected = np.asarray(selected)
        if self.sizes_fn is None:
            return np.ones(selected.shape, np.float32)
        return np.asarray(self.sizes_fn(selected), np.float32)
