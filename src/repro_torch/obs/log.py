"""Host-side metrics collection: the schema-versioned JSONL sink.

The port's copy of the JAX package's ``obs/log.py``: the same rows
under the same ``SCHEMA_VERSION``, so a file one package writes
validates and reports in the other. The header's provenance names
torch, CUDA and the card (``obs/provenance.py``).

One run = one JSONL file (``--metrics-out``):

  {"kind": "header", "schema": 3, "provenance": {...}, "config": {...},
   "payload_bytes": N, "resumed_at": t | null}
  {"kind": "round", "t": 0, "loss": ..., "n_on_time": ...,
   "n_limited": ..., "n_delayed": ..., "mean_delay": ...,
   "stale_hist": [...], "alpha_eff": ..., "delta_norm": ...,
   "update_norm": ..., "bytes_on_wire": ...}          # one per round
  {"kind": "eval", "t": 5, "test_acc": ..., "test_loss": ...}
  {"kind": "phases", "phases": {"stage": {"seconds": ..., "calls": ...},
   "compile": ..., "scan_dispatch": ..., "eval": ..., "checkpoint": ...}}

The serving rows ("serve" per request, "serve_summary" per run) are
written by ``launch.serve --metrics-out`` and validated as in the JAX
package.

Round rows are pure functions of the round they describe (absolute
``t``, device-computed values), so a resumed run's file is bit-identical
to the tail of the uninterrupted run's file, the JSONL analogue of the
engine's save -> restore -> continue contract. Wall-clock rows
("phases") and the header are excluded from that contract.

``validate_rows`` is the schema checker (``repro_torch.obs.report``
refuses a file it rejects).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

#: v2 adds the serving-plane rows ("serve", "serve_summary"); v3 adds
#: the comm-plane wire fields on round rows (bytes_on_wire_compressed,
#: compression_ratio — optional, like every extended round metric);
#: v1/v2 files (without them) remain readable
SCHEMA_VERSION = 3
SUPPORTED_SCHEMAS = (1, 2, 3)

#: required keys per row kind (extended round metrics are optional —
#: a base run logs only loss/participation)
REQUIRED = {
    "header": ("schema",),
    "round": ("t", "loss", "n_on_time"),
    "eval": ("t", "test_acc", "test_loss"),
    "phases": ("phases",),
    "serve": ("id", "new_tokens"),
    "serve_summary": ("requests", "tokens_per_s"),
}
KINDS = tuple(REQUIRED)

#: per-request latency series a serve row may carry (all seconds)
SERVE_LATENCY_KEYS = ("queue_s", "prefill_s", "decode_s", "total_s")


def _py(x):
    """JSON-ready scalar/list from a numpy value or a CPU tensor."""
    a = np.asarray(x)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


class MetricsLogger:
    """Streams run telemetry to a JSONL file (or collects in memory
    with ``path=None`` — the tests' sink). The engine calls ``header``
    once, ``rounds`` per executed chunk, ``eval`` per eval point and
    ``phases`` when a run segment finishes."""

    def __init__(self, path: str | None):
        self.path = path
        self.rows: list[dict] = []        # in-memory mirror (path=None
        self._f = open(path, "w") if path else None   # keeps only this)
        self._header_done = False

    # ------------------------------------------------------------ rows --
    def _emit(self, row: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        else:
            self.rows.append(row)

    def header(self, fl=None, *, payload: int | None = None,
               resumed_at: int | None = None, extra: dict | None = None
               ) -> None:
        """The one-per-file header row (idempotent: later calls no-op,
        so engine re-entry across run() calls appends rounds, not
        headers)."""
        if self._header_done:
            return
        self._header_done = True
        from repro_torch.obs.provenance import provenance
        cfg = (dataclasses.asdict(fl) if dataclasses.is_dataclass(fl)
               else dict(fl or {}))
        self._emit({"kind": "header", "schema": SCHEMA_VERSION,
                    "provenance": provenance(), "config": cfg,
                    "payload_bytes": payload, "resumed_at": resumed_at,
                    **(extra or {})})

    def rounds(self, t0: int, metrics: dict) -> None:
        """One row per round of a chunk: ``metrics`` leaves carry a
        leading (n,) axis (the stacked scan ys back on host). ``t0`` is
        the absolute round counter ENTERING the chunk; rows are labeled
        by the round they complete (t0+1 .. t0+n), the same 1-indexed
        absolute convention as eval rows, ``resumed_at`` and
        ``History.eval_rounds`` — so a resumed run's tail is directly
        comparable to the uninterrupted run's."""
        n = len(np.asarray(metrics["loss"]))
        for i in range(n):
            row = {"kind": "round", "t": int(t0) + i + 1}
            for k, v in metrics.items():
                row[k] = _py(np.asarray(v)[i])
            self._emit(row)

    def eval(self, t: int, test_acc: float, test_loss: float) -> None:
        self._emit({"kind": "eval", "t": int(t),
                    "test_acc": float(test_acc),
                    "test_loss": float(test_loss)})

    def phases(self, times) -> None:
        """Serialize a ``PhaseTimes`` summary (or a plain dict)."""
        summary = times.summary() if hasattr(times, "summary") else times
        self._emit({"kind": "phases", "phases": summary})

    def serve(self, result: dict) -> None:
        """One per-request serving row (an engine result: id,
        new_tokens, queue_s/prefill_s/decode_s/total_s). The token ids
        are NOT logged: telemetry, not transcripts."""
        row = {"kind": "serve", "id": int(result["id"]),
               "new_tokens": int(result["new_tokens"])}
        for k in SERVE_LATENCY_KEYS:
            if k in result:
                row[k] = round(float(result[k]), 6)
        self._emit(row)

    def serve_summary(self, summary: dict) -> None:
        """The one-per-run aggregate: tokens/s and latency percentiles
        (an engine's ``last_summary``)."""
        self._emit({"kind": "serve_summary", **summary})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# reading + validation (report CLI, scripts/check_metrics.py)
# ----------------------------------------------------------------------

def read_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSON ({e})") from None
    return rows


def validate_rows(rows: list[dict]) -> list[str]:
    """Schema violations as human-readable strings ([] = valid).

    Checks: a leading header row with a known schema version, known row
    kinds, required keys present with sane types, round indices strictly
    increasing, eval rows aligned to logged rounds."""
    errs = []
    if not rows:
        return ["empty file (no header row)"]
    if rows[0].get("kind") != "header":
        errs.append("first row must be kind=header, got "
                    f"{rows[0].get('kind')!r}")
    elif rows[0].get("schema") not in SUPPORTED_SCHEMAS:
        errs.append(f"unsupported schema {rows[0].get('schema')!r} "
                    f"(reader supports {SUPPORTED_SCHEMAS})")
    prev_t = None
    for i, row in enumerate(rows):
        kind = row.get("kind")
        if kind not in KINDS:
            errs.append(f"row {i}: unknown kind {kind!r}")
            continue
        if kind == "header" and i > 0:
            errs.append(f"row {i}: duplicate header")
        missing = [k for k in REQUIRED[kind] if k not in row]
        if missing:
            errs.append(f"row {i} ({kind}): missing keys {missing}")
            continue
        if kind == "round":
            if not isinstance(row["t"], int):
                errs.append(f"row {i}: round t must be int, got "
                            f"{type(row['t']).__name__}")
            elif prev_t is not None and row["t"] <= prev_t:
                errs.append(f"row {i}: round t={row['t']} not after "
                            f"t={prev_t}")
            else:
                prev_t = row["t"]
            for k in ("loss", "mean_delay", "alpha_eff", "delta_norm",
                      "update_norm", "bytes_on_wire",
                      "bytes_on_wire_compressed", "compression_ratio"):
                if k in row and not isinstance(row[k], (int, float)):
                    errs.append(f"row {i}: {k} must be numeric")
            for k in ("bytes_on_wire_compressed", "compression_ratio"):
                if isinstance(row.get(k), (int, float)) and row[k] < 0:
                    errs.append(f"row {i}: {k} must be >= 0")
            if "stale_hist" in row and not isinstance(row["stale_hist"],
                                                      list):
                errs.append(f"row {i}: stale_hist must be a list")
        if kind == "eval":
            for k in ("test_acc", "test_loss"):
                if not isinstance(row[k], (int, float)):
                    errs.append(f"row {i}: {k} must be numeric")
            if prev_t is not None and row["t"] > prev_t:
                errs.append(f"row {i}: eval at t={row['t']} beyond last "
                            f"logged round t={prev_t}")
        if kind == "serve":
            for k in ("id", "new_tokens"):
                if not isinstance(row[k], int):
                    errs.append(f"row {i}: {k} must be int")
            for k in SERVE_LATENCY_KEYS:
                if k in row and not isinstance(row[k], (int, float)):
                    errs.append(f"row {i}: {k} must be numeric")
                elif isinstance(row.get(k), (int, float)) and row[k] < 0:
                    errs.append(f"row {i}: {k} must be >= 0")
        if kind == "serve_summary":
            for k in ("requests", "new_tokens", "tokens_per_s"):
                if k in row and not isinstance(row[k], (int, float)):
                    errs.append(f"row {i}: {k} must be numeric")
    return errs
