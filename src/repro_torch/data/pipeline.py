"""Client data pipeline: per-round sampling + the vectorized chunk stager.

The port's copy of the host half of ``repro.data.pipeline`` (numpy). The
engine consumes data in CHUNKS of rounds: one fancy-gather produces the
whole ``(n_rounds, C, steps, b, ...)`` batch array a chunk needs, which
then crosses to the device in one copy per field.

THE STAGING CONTRACT (mirrors the ``Environment`` schedule contract):
round t's batch indices are a pure function of (seed, t, selected[t]) —
``stage_chunk(t0, n)`` row i is bit-identical to staging round t0+i on
its own, and to the JAX package's staging of the same round.
"""
from __future__ import annotations

import numpy as np


def sample_shard_steps(indices: np.ndarray, rng: np.random.RandomState,
                       steps: int, batch_size: int) -> np.ndarray:
    """(steps, batch) global indices from one shard, reshuffled-epoch
    order — THE sampling algorithm."""
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


def build_clients(data: dict, partition: list[np.ndarray]) -> list[ClientDataset]:
    return [ClientDataset(data, idx) for idx in partition]


def stage_rng(seed: int, t: int) -> np.random.RandomState:
    """Round t's batch-sampling stream — independent per round, keyed on
    the absolute round index (cf. ``env.base.round_rng``), so staging is
    pure in t and survives chunking unchanged."""
    return np.random.RandomState(
        (seed * 1_000_003 + t + 0x51ED270) % 2**32)


def stage_round_indices(clients, selected: np.ndarray, seed: int, t: int,
                        steps: int, batch_size: int) -> np.ndarray:
    """(C, steps, batch) global indices for round t's selected clients,
    drawn from the shared per-round stream in selected order."""
    rng = stage_rng(seed, t)
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
