"""Client data pipeline: per-round sampling, the streamed K-free client
shards, the vectorized chunk stager, the partitioned client plane's
dispatch plan and the chunk prefetcher.

The port's copy of the host half of ``repro.data.pipeline`` (numpy). The
engine consumes data in CHUNKS of rounds: one fancy-gather produces the
whole ``(n_rounds, C, steps, b, ...)`` batch array a chunk needs, which
then crosses to the device in one copy per field.

THE STAGING CONTRACT (mirrors the ``Environment`` schedule contract):
round t's batch indices are a pure function of (seed, t, selected[t]) —
``stage_chunk(t0, n)`` row i is bit-identical to staging round t0+i on
its own, and to the JAX package's staging of the same round.

``ChunkPrefetcher`` stages chunk k+1 on a host thread while chunk k runs
on the card.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


def sample_shard_steps(indices: np.ndarray, rng: np.random.RandomState,
                       steps: int, batch_size: int) -> np.ndarray:
    """(steps, batch) global indices from one shard, reshuffled-epoch
    order — THE sampling algorithm, shared by the dense ``ClientDataset``
    list and the K-free ``VirtualClientShards`` so both draw
    bit-identical streams from identical shard index arrays."""
    n = len(indices)
    need = steps * batch_size
    reps = int(np.ceil(need / max(n, 1)))
    idx = np.concatenate([rng.permutation(indices) for _ in range(reps)])
    return idx[:need].reshape(steps, batch_size)


class ClientDataset:
    """One client's local shard with epoch-style batch sampling."""

    def __init__(self, data: dict, indices: np.ndarray):
        self.data = data
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def sample_step_indices(self, rng: np.random.RandomState, steps: int,
                            batch_size: int) -> np.ndarray:
        """(steps, batch) GLOBAL sample indices, reshuffled-epoch order."""
        return sample_shard_steps(self.indices, rng, steps, batch_size)

    def sample_steps(self, rng: np.random.RandomState, steps: int,
                     batch_size: int):
        """(steps, batch, ...) arrays, sampling with reshuffled epochs."""
        idx = self.sample_step_indices(rng, steps, batch_size)
        return {k: v[idx] for k, v in self.data.items()}


def build_clients(data: dict, partition: list[np.ndarray]) -> list[ClientDataset]:
    return [ClientDataset(data, idx) for idx in partition]


class VirtualClientShards:
    """K clients over ONE base store with no per-client objects: the
    staging half of a virtual population (``env.virtual``).

    A single base permutation (drawn once from the staging seed, off the
    round axis) defines every shard arithmetically: client i owns
    ``order[(i * shard_size + j) % n]`` for j < shard_size. Client i's
    shard is therefore a pure function of (i, seed); nothing is
    materialised per client, so K = 10^6 costs the same as K = 20. Once
    K * shard_size exceeds the base store the shards overlap by wrapping
    around the permutation (distinct clients still hold distinct,
    deterministic index sets).

    Duck-type contract with ``list[ClientDataset]`` where the engine and
    stager need it: ``len``, ``.data`` and per-client index sampling;
    dispatch is on the ``shard_indices`` attribute.
    """

    def __init__(self, data: dict, num_clients: int,
                 shard_size: int | None = None, seed: int = 0):
        self.data = data
        self.num_clients = int(num_clients)
        self.n = len(next(iter(data.values())))
        if shard_size is None:
            shard_size = max(1, self.n // self.num_clients)
        self.shard_size = int(shard_size)
        assert 0 < self.shard_size <= self.n, (self.shard_size, self.n)
        self.order = np.random.RandomState(
            (seed + 0xA5F152) % 2**32).permutation(self.n)

    def __len__(self):
        return self.num_clients

    @property
    def min_size(self) -> int:
        return self.shard_size

    def shard_indices(self, i: int) -> np.ndarray:
        start = (int(i) * self.shard_size) % self.n
        return self.order[(start + np.arange(self.shard_size)) % self.n]

    def sample_step_indices(self, i: int, rng: np.random.RandomState,
                            steps: int, batch_size: int) -> np.ndarray:
        return sample_shard_steps(self.shard_indices(i), rng, steps,
                                  batch_size)

    def client_sizes(self, selected: np.ndarray) -> np.ndarray:
        """|D_i| aggregation weights: the ``data_sizes`` callable the
        environment layer consumes (``env.resolve(fl, data_sizes=...)``)."""
        return np.full(np.shape(selected), self.shard_size, np.float32)


def stage_rng(seed: int, t: int) -> np.random.RandomState:
    """Round t's batch-sampling stream — independent per round, keyed on
    the absolute round index (cf. ``env.base.round_rng``), so staging is
    pure in t and survives chunking unchanged."""
    return np.random.RandomState(
        (seed * 1_000_003 + t + 0x51ED270) % 2**32)


def stage_round_indices(clients, selected: np.ndarray, seed: int, t: int,
                        steps: int, batch_size: int) -> np.ndarray:
    """(C, steps, batch) global indices for round t's selected clients.

    ``clients`` is either the dense ``list[ClientDataset]`` or a
    ``VirtualClientShards``; both draw from the shared per-round stream
    in selected order, so a dense list built from ``shards
    .shard_indices`` stages bit-identical batches. Cost is O(C x steps x
    batch) either way, never O(K)."""
    rng = stage_rng(seed, t)
    if hasattr(clients, "shard_indices"):
        return np.stack([clients.sample_step_indices(int(i), rng, steps,
                                                     batch_size)
                         for i in selected])
    return np.stack([clients[int(i)].sample_step_indices(rng, steps,
                                                         batch_size)
                     for i in selected])


def stage_chunk(data: dict, clients, selected: np.ndarray, seed: int,
                t0: int, steps: int, batch_size: int) -> dict:
    """Stage a whole chunk of rounds with ONE gather per data field.

    selected: (n_rounds, C) client indices (``Environment.batch`` rows).
    Returns {field: (n_rounds, C, steps, batch, ...)} numpy arrays. Row i
    is bit-identical to staging round ``t0 + i`` alone.
    """
    selected = np.asarray(selected)
    idx = np.stack([stage_round_indices(clients, selected[i], seed, t0 + i,
                                        steps, batch_size)
                    for i in range(selected.shape[0])])
    return {k: v[idx] for k, v in data.items()}


def partition_plan(limited: np.ndarray) -> dict:
    """Host-side dispatch plan of the PARTITIONED client plane.

    ``limited``: (n_rounds, C) bool, the chunk's stacked FES flags from
    ``Environment.batch``. Each round's cohorts are grouped by
    limited-ness into two programs whose widths are the same for every
    round of the chunk:

      * the limited (classifier-only / truncated) program takes
        ``L = min`` over the chunk's rounds of the limited count;
      * the full (masked) program takes the other ``U = C - L`` slots:
        the unlimited cohorts and any round's OVERFLOW limited cohorts,
        which stay correct there (masked, just not reduced).

    A 1-round chunk (the pod path's ``--no-scan`` loop) gets the exact
    per-round split. The arrays (consumed by
    ``core.client.make_partitioned_local_train`` through the schedule
    dict), bitwise the JAX package's:

      part_full_idx (n, U) — cohort slot feeding full-program row u
      part_lim_idx  (n, L) — cohort slot feeding limited-program row l
      part_src_row  (n, C) — slot c's row in its program's output
      part_from_lim (n, C) — True where that program is the limited one
    """
    limited = np.asarray(limited, bool)
    if limited.ndim != 2:
        raise ValueError(f"limited must be (n_rounds, C), got "
                         f"{limited.shape}")
    n, C = limited.shape
    L = int(limited.sum(axis=1).min())
    U = C - L
    full_idx = np.zeros((n, U), np.int32)
    lim_idx = np.zeros((n, L), np.int32)
    src_row = np.zeros((n, C), np.int32)
    from_lim = np.zeros((n, C), bool)
    for i in range(n):
        lim = np.flatnonzero(limited[i])[:L].astype(np.int32)
        full = np.setdiff1d(np.arange(C, dtype=np.int32), lim)
        lim_idx[i], full_idx[i] = lim, full
        from_lim[i, lim] = True
        src_row[i, lim] = np.arange(L, dtype=np.int32)
        src_row[i, full] = np.arange(U, dtype=np.int32)
    return {"part_full_idx": full_idx, "part_lim_idx": lim_idx,
            "part_src_row": src_row, "part_from_lim": from_lim}


class ChunkPrefetcher:
    """Stage chunk k+1 on a host thread while chunk k runs on the card.

    ``fn(item)`` is called on ONE worker thread in item order (so a
    stateful environment stages as it would inline); at most ``depth``
    staged chunks wait ahead of the consumer. An exception in ``fn`` is
    raised on the consumer's side, at the chunk it failed on.
    """

    def __init__(self, fn, items, depth: int = 1):
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._n = len(items)
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():      # a closed consumer
                try:                            # releases the worker
                    self._q.put(item, timeout=0.1)
                    return True
                # fedlint: disable=FED106 — bounded 0.1s poll; _stop is the exit
                except queue.Full:
                    continue
            return False

        def work():
            for it in items:
                if self._stop.is_set():
                    return
                try:
                    staged = (fn(it), None)
                except Exception as e:          # surface on the consumer side
                    put((None, e))
                    return
                if not put(staged):
                    return

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop staging and drop the buffered chunks (an abandoned
        iteration)."""
        self._stop.set()
        self._drain()
        # an in-flight put can land after the first drain; once the
        # worker sees the stop flag and exits, drain what it left
        self._thread.join(timeout=1.0)
        self._drain()

    def __iter__(self):
        try:
            for _ in range(self._n):
                out, err = self._q.get()
                if err is not None:
                    raise err
                yield out
        finally:
            self.close()


def batch_iterator(data: dict, batch_size: int, seed: int = 0):
    """Endless centralised batches: one reshuffled epoch after another."""
    n = len(next(iter(data.values())))
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sl = order[i:i + batch_size]
            yield {k: v[sl] for k, v in data.items()}
