"""The benchmark's one traffic generator.

A traffic mix is a data file, ``portbench/traffic/<name>.json``, of
parameters this module reads: the cohorts C a round, the local steps,
the rows b a step and their length S, the share of computing-limited
cohorts ``p_limited``, the algorithm, the client plane and the
hyper-parameters (lr, alpha0, eta, alpha_cap). Round r of seed n gets:

  * fresh token ids, uniform over the vocabulary, (C, steps, b, S),
    drawn on the device from a generator seeded by (n, r);
  * exactly round(C p_limited) limited cohorts, which ones drawn from
    (n, r), so every round carries the same work;
  * every cohort on time (no delay) with an equal data size.

The program and the reference are given the same rounds.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

#: keys every traffic file has
KEYS = ("cohorts", "local_steps", "batch", "seq", "p_limited", "algorithm",
        "client_plane", "lr", "alpha0", "eta", "alpha_cap")


def stream_seed(seed: int, *tag) -> int:
    """A 63-bit seed of (seed, *tag): any whole number gives a valid
    one, and distinct tags give unrelated streams."""
    h = hashlib.sha256(":".join(map(str, (seed, *tag))).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def weights_generator(seed: int, device) -> torch.Generator:
    """The generator both sides draw the initial weights from, on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))
    return gen


def n_limited(traffic: dict) -> int:
    return int(round(traffic["cohorts"] * traffic["p_limited"]))


def tokens_per_round(traffic: dict) -> int:
    return (traffic["cohorts"] * traffic["local_steps"] * traffic["batch"]
            * traffic["seq"])


def round_tokens(traffic: dict, vocab: int, seed: int, r: int, device):
    """(C, steps, b, S) int32 token ids of round r, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "tokens", r))
    shape = (traffic["cohorts"], traffic["local_steps"], traffic["batch"],
             traffic["seq"])
    return torch.randint(0, vocab, shape, generator=gen, dtype=torch.int32,
                         device=device)


def round_limited(traffic: dict, seed: int, r: int) -> np.ndarray:
    """(C,) bool: the round's computing-limited cohorts."""
    C = traffic["cohorts"]
    rng = np.random.default_rng(stream_seed(seed, "limited", r))
    out = np.zeros(C, dtype=bool)
    out[rng.choice(C, n_limited(traffic), replace=False)] = True
    return out


def round_schedule(traffic: dict, seed: int, r: int) -> dict:
    """The round's schedule as a one-round chunk (leading axis 1), the
    keys ``Environment.batch`` gives the engine."""
    C = traffic["cohorts"]
    return {"limited": round_limited(traffic, seed, r)[None],
            "delayed": np.zeros((1, C), dtype=bool),
            "delays": np.zeros((1, C), dtype=np.int32),
            "data_sizes": np.ones((1, C), dtype=np.float32)}
