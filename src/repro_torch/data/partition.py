"""Non-iid client partitioners.

``shard_partition`` is the paper's setting ([1]'s pathological non-iid):
sort by label, cut into 2*K shards, give each client 2 shards -> each
client holds samples from at most two classes.

``dirichlet_partition`` is the standard milder alternative (ablations).
The port's copy of the JAX package's ``data/partition.py`` (numpy):
every partition is bitwise the JAX package's.
"""
from __future__ import annotations

import numpy as np


def shard_partition(labels: np.ndarray, num_clients: int,
                    shards_per_client: int = 2, seed: int = 0):
    """Each client receives ``shards_per_client`` single-class shards, so it
    sees at most that many classes — the paper's strict property. (Naive
    sort-and-cut lets shards straddle class boundaries.) Exact cover: every
    sample is assigned to exactly one client."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    # class slot list: 2*K slots cycling through classes, shuffled
    slots = np.array([i % n_classes
                      for i in range(num_clients * shards_per_client)])
    rng.shuffle(slots)
    idx_by_class = []
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        idx_by_class.append(idx)
    # first pass: every class that has samples needs at least one slot
    # (possible when n_classes > shards_per_client * num_clients)
    extra_slots = []   # (client, class) — only when slots < classes
    for c in range(n_classes):
        if len(idx_by_class[c]) and not np.any(slots == c):
            # steal a slot from a class with more than one holder
            donors = [s for s in range(len(slots))
                      if np.sum(slots == slots[s]) > 1]
            if donors:
                slots[donors[rng.randint(len(donors))]] = c
            else:
                # fewer slots than classes: exact cover wins over the
                # <=shards_per_client-classes property (degenerate regime;
                # the paper's K=50, 2 shards, 10 classes never hits this)
                extra_slots.append((rng.randint(num_clients), c))
    # second pass: split each class's samples among its holders
    class_chunks = {}
    for c in range(n_classes):
        holders = np.where(slots == c)[0]
        if len(holders) == 0:
            class_chunks[c] = {}
            continue
        class_chunks[c] = dict(
            zip(holders.tolist(), np.array_split(idx_by_class[c],
                                                 len(holders))))
    out = []
    for client in range(num_clients):
        mine = []
        for s in range(shards_per_client):
            slot = client * shards_per_client + s
            c = slots[slot]
            if slot in class_chunks[c]:
                mine.append(class_chunks[c][slot])
        for cl, c in extra_slots:
            if cl == client:
                mine.append(idx_by_class[c])
        idx = (np.concatenate(mine) if mine
               else np.array([], dtype=np.int64))
        rng.shuffle(idx)
        out.append(idx.astype(np.int64))
    return out


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0):
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    client_idx = [[] for _ in range(num_clients)]
    for idx in idx_by_class:
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for c, part in enumerate(np.split(idx, cuts)):
            client_idx[c].append(part)
    out = []
    for c in range(num_clients):
        idx = np.concatenate(client_idx[c]) if client_idx[c] else np.array([], int)
        rng.shuffle(idx)
        out.append(idx.astype(np.int64))
    return out


def iid_partition(n: int, num_clients: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return [a.astype(np.int64) for a in np.array_split(idx, num_clients)]
