"""Host-side stability math (numpy): the port's copy of the JAX
package's ``obs/metrics.py: window_by_rounds, stability_stats``."""
from __future__ import annotations

import numpy as np


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
