"""Per-round telemetry series and the shared stability math.

The port's copy of the JAX package's ``obs/metrics.py``.
``round_metrics`` runs inside the round (``core/round.py`` under
``fl.extended_metrics``) on values the round already has: the schedule,
the stacked client params, the global model before and after, the
strategy's aux state. It only reads them, so the params stream is the
same with it on or off. ``stability_stats`` is the one implementation
of the paper's stability window, used by ``exec.engine.History`` and
the report CLI (``repro_torch.obs.report``) alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import leaves, tree_map

#: per-round metric keys an extended-metrics run emits (beyond the base
#: {"loss", "n_on_time"}); ``stale_hist`` is a vector of ``max_delay +
#: 1`` staleness-bin counts, everything else a scalar
ROUND_METRIC_KEYS = ("n_limited", "n_delayed", "mean_delay", "stale_hist",
                     "alpha_eff", "delta_norm", "update_norm",
                     "bytes_on_wire", "bytes_on_wire_compressed",
                     "compression_ratio")


def payload_bytes(params) -> int:
    """Bytes of ONE client's model-update upload: the whole parameter
    tree at its stored dtypes (an upper bound under FES, as in the JAX
    package)."""
    return int(sum(x.numel() * x.element_size() for x in leaves(params)))


def _global_norm(tree, shard_sum=None):
    """f32 l2 norm over every element of every leaf; ``shard_sum`` adds
    the squares of every rank's block first (a tree of cohort blocks)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq if shard_sum is None else shard_sum(sq))


def round_metrics(fl, strategy, t, prev_global, client_params, new_params,
                  sched, aux_state, *, payload: int,
                  payload_compressed: int | None = None,
                  shard_sum=None) -> dict:
    """The extended per-round metric dict, device tensors of fixed
    shapes:

    * participation: ``n_limited`` / ``n_delayed`` cohort counts;
    * staleness: ``mean_delay`` over the delayed cohorts and
      ``stale_hist``, the delays binned into ``max_delay + 1`` bins;
    * aggregation: ``alpha_eff``, the strategy's effective
      previous-model mix coefficient (``mix_coefficient``);
    * magnitudes: ``delta_norm``, the l2 norm of the stacked client
      deltas, and ``update_norm``, that of the server step taken;
    * wire: ``bytes_on_wire`` = on-time uploads x ``payload``;
      ``bytes_on_wire_compressed`` the same count x the comm plane's
      actual bytes; ``compression_ratio`` dense / compressed.

    Under a mesh whose pre-reduced client axis leaves each rank its own
    cohort block, ``client_params`` is that block and ``shard_sum``
    (``sharding.ctx.sum_shards``) sums ``delta_norm``'s squares across
    the ranks.
    """
    delayed = sched["delayed"].float()
    delays = sched["delays"].float()
    n_delayed = delayed.sum()
    n_on_time = sched["delayed"].shape[0] - n_delayed
    bins = max(fl.max_delay, 0) + 1
    d_int = sched["delays"].to(torch.int32)
    onehot = (d_int[:, None] == torch.arange(bins, device=d_int.device)
              [None, :]).float() * delayed[:, None]
    stale_hist = onehot.sum(dim=0).to(torch.int32)
    mean_delay = (delays * delayed).sum() / torch.clamp(n_delayed, min=1.0)
    deltas = tree_map(lambda c, p: c.float() - p.float()[None],
                      client_params, prev_global)
    step = tree_map(lambda n, p: n.float() - p.float(), new_params,
                    prev_global)
    ratio = 1.0 if payload_compressed is None else (
        payload / max(payload_compressed, 1))
    return {
        "n_limited": sched["limited"].sum(dtype=torch.int32),
        "n_delayed": n_delayed.to(torch.int32),
        "mean_delay": mean_delay,
        "stale_hist": stale_hist,
        "alpha_eff": strategy.mix_coefficient(t, sched, aux_state).float(),
        "delta_norm": _global_norm(deltas, shard_sum),
        "update_norm": _global_norm(step),
        "bytes_on_wire": n_on_time * float(payload),
        "bytes_on_wire_compressed": n_on_time * float(
            payload if payload_compressed is None else payload_compressed),
        "compression_ratio": torch.full((), ratio, dtype=torch.float32,
                                        device=delayed.device),
    }


# ------------------------------------------------------------------
# host-side stability math (numpy): History and the report CLI
# ------------------------------------------------------------------


def window_by_rounds(eval_rounds, last: int) -> np.ndarray:
    """Boolean mask over eval points selecting the last ``last`` ROUNDS:
    an eval at absolute round t is in the window iff
    t > max(eval_rounds) - last, whatever the eval cadence."""
    rounds = np.asarray(eval_rounds, np.int64)
    if rounds.size == 0:
        return np.zeros((0,), bool)
    return rounds > (rounds.max() - int(last))


def stability_stats(eval_rounds, test_acc, last: int = 50) -> dict:
    """Paper metrics over the last ``last`` rounds: mean accuracy and
    the stability variance (variance of test accuracy in percentage
    points squared)."""
    accs = np.asarray(test_acc, np.float64)[window_by_rounds(eval_rounds,
                                                              last)]
    if accs.size == 0:
        return {"final_accuracy": float("nan"),
                "stability_variance": float("nan"), "n_evals": 0}
    return {"final_accuracy": float(np.mean(accs)),
            "stability_variance": float(np.var(accs * 100.0)),
            "n_evals": int(accs.size)}
