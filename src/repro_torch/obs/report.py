"""The run-report CLI: Fig. 2/3-style numbers from any metrics JSONL.

The port's copy of the JAX package's ``obs/report.py``; it reads the
same schema, so it reports a file of either package.

  python -m repro_torch.obs.report run.jsonl
  python -m repro_torch.obs.report run.jsonl --last 50
  python -m repro_torch.obs.report --compare a.jsonl b.jsonl

Renders the stability / staleness / participation / mix / throughput
summary of a run recorded with ``--metrics-out`` — no bespoke benchmark
script needed to read the paper's headline quantities off a run. The
accuracy block calls the SAME ``stability_stats`` the engine's
``History`` uses (round-windowed), so ``final_accuracy`` and
``stability_variance`` here reproduce the in-process values exactly.

``--compare`` prints two runs side by side with deltas on the headline
scalars plus any provenance mismatch (torch version, card, git sha) —
the A/B view for scenario or algorithm sweeps.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch.obs.provenance import diff as provenance_diff
from repro_torch.obs.log import read_rows, validate_rows
from repro_torch.obs.metrics import stability_stats


def history_from_rows(rows: list[dict]):
    """Rebuild the engine's ``History`` from JSONL rows — the exactness
    bridge between a file on disk and ``SimulationEngine.run``'s
    in-process record."""
    from repro_torch.exec.engine import History
    h = History()
    for r in rows:
        if r.get("kind") == "round":
            h.train_loss.append(float(r["loss"]))
        elif r.get("kind") == "eval":
            h.test_acc.append(float(r["test_acc"]))
            h.test_loss.append(float(r["test_loss"]))
            h.eval_rounds.append(int(r["t"]))
    return h


def _mean(xs):
    return float(np.mean(xs)) if len(xs) else float("nan")


def summarize(rows: list[dict], last: int = 50) -> dict:
    """One flat summary dict per run (everything ``render`` prints)."""
    header = rows[0] if rows and rows[0].get("kind") == "header" else {}
    rnd = [r for r in rows if r.get("kind") == "round"]
    ev = [r for r in rows if r.get("kind") == "eval"]
    phases = [r for r in rows if r.get("kind") == "phases"]
    cfg = header.get("config", {}) or {}
    out = {
        "algorithm": cfg.get("algorithm"), "env": cfg.get("env"),
        "schema": header.get("schema"),
        "provenance": header.get("provenance"),
        "rounds": len(rnd),
        "t_first": rnd[0]["t"] if rnd else None,
        "t_last": rnd[-1]["t"] if rnd else None,
        "train_loss_last": rnd[-1]["loss"] if rnd else None,
    }
    out.update(stability_stats([r["t"] for r in ev],
                               [r["test_acc"] for r in ev], last))
    C = cfg.get("clients_per_round") or None
    if rnd:
        on_time = [r["n_on_time"] for r in rnd]
        out["on_time_mean"] = _mean(on_time)
        if C:
            out["on_time_frac"] = _mean(on_time) / C
            if "n_limited" in rnd[0]:
                out["limited_frac"] = _mean(
                    [r["n_limited"] for r in rnd]) / C
    if rnd and "stale_hist" in rnd[0]:         # extended-metrics series
        hist = np.sum([r["stale_hist"] for r in rnd], axis=0)
        delayed_rows = [r["mean_delay"] for r in rnd
                        if r.get("n_delayed", 0) > 0]
        out.update({
            "stale_hist": hist.astype(int).tolist(),
            "max_staleness_seen": int(np.nonzero(hist)[0].max())
            if hist.any() else 0,
            "mean_delay": _mean(delayed_rows),
            "alpha_eff_first": rnd[0]["alpha_eff"],
            "alpha_eff_last": rnd[-1]["alpha_eff"],
            "delta_norm_mean": _mean([r["delta_norm"] for r in rnd]),
            "update_norm_mean": _mean([r["update_norm"] for r in rnd]),
            "bytes_on_wire_total": float(
                np.sum([r["bytes_on_wire"] for r in rnd])),
        })
    if phases:
        ph = phases[-1]["phases"]              # last segment's summary
        out["phases"] = ph
        train_s = sum(ph[k]["seconds"] for k in
                      ("compile", "scan_dispatch", "round_dispatch")
                      if k in ph)
        if train_s > 0:
            out["rounds_per_sec"] = len(rnd) / train_s
    return out


def _fmt(x, spec=".4f"):
    if x is None or (isinstance(x, float) and np.isnan(x)):
        return "-"
    if isinstance(x, float):
        return format(x, spec)
    return str(x)


def render(s: dict, label: str = "") -> str:
    lines = []
    if label:
        lines.append(f"== {label} ==")
    lines.append(f"run: algorithm={s['algorithm']} env={s['env']} "
                 f"rounds={s['rounds']} (t={s['t_first']}..{s['t_last']}) "
                 f"schema={s['schema']}")
    lines.append(f"accuracy: final={_fmt(s['final_accuracy'])} "
                 f"stability_var={_fmt(s['stability_variance'], '.3f')} "
                 f"(pp^2, {s['n_evals']} evals in round window) "
                 f"train_loss={_fmt(s['train_loss_last'])}")
    if "on_time_frac" in s:
        part = (f"participation: on_time={s['on_time_frac']:.1%}")
        if "limited_frac" in s:
            part += f" limited={s['limited_frac']:.1%}"
        lines.append(part)
    if "stale_hist" in s:
        lines.append(f"staleness: hist={s['stale_hist']} "
                     f"max_seen={s['max_staleness_seen']} "
                     f"mean_delay={_fmt(s['mean_delay'], '.2f')}")
        lines.append(f"mix: alpha_eff {_fmt(s['alpha_eff_first'])} -> "
                     f"{_fmt(s['alpha_eff_last'])}   "
                     f"|delta|={_fmt(s['delta_norm_mean'], '.3f')} "
                     f"|update|={_fmt(s['update_norm_mean'], '.3f')}")
        lines.append(f"wire: {s['bytes_on_wire_total'] / 1e6:.2f} MB "
                     f"uploaded on time "
                     f"({s['bytes_on_wire_total'] / 1e6 / max(s['rounds'], 1):.3f} MB/round)")
    if "phases" in s:
        total = sum(v["seconds"] for v in s["phases"].values()) or 1.0
        breakdown = "  ".join(
            f"{k}={v['seconds']:.2f}s({v['seconds'] / total:.0%})"
            for k, v in s["phases"].items())
        tput = (f" | {s['rounds_per_sec']:.2f} rounds/s"
                if "rounds_per_sec" in s else "")
        lines.append(f"phases: {breakdown}{tput}")
    return "\n".join(lines)


#: headline scalars --compare prints deltas for
DELTA_KEYS = ("final_accuracy", "stability_variance", "on_time_frac",
              "mean_delay", "alpha_eff_last", "bytes_on_wire_total",
              "rounds_per_sec")


def compare(sa: dict, sb: dict) -> str:
    lines = [render(sa, "A"), "", render(sb, "B"), "", "-- deltas (B - A) --"]
    for k in DELTA_KEYS:
        if isinstance(sa.get(k), (int, float)) and isinstance(
                sb.get(k), (int, float)):
            lines.append(f"{k}: {sa[k]:.4f} -> {sb[k]:.4f} "
                         f"({sb[k] - sa[k]:+.4f})")
    pd = provenance_diff(sa.get("provenance"), sb.get("provenance"))
    if pd:
        lines.append("provenance mismatch: " + "; ".join(pd))
    return "\n".join(lines)


def _load(path: str) -> list[dict]:
    rows = read_rows(path)
    errs = validate_rows(rows)
    if errs:
        for e in errs:
            print(f"{path}: SCHEMA ERROR: {e}", file=sys.stderr)
        raise SystemExit(2)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a --metrics-out JSONL run record.")
    ap.add_argument("jsonl", nargs="?", help="metrics JSONL to report on")
    ap.add_argument("--last", type=int, default=50,
                    help="stability window in ROUNDS (paper: 50)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="A/B summary of two runs with deltas")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (summarize(_load(p), args.last) for p in args.compare)
        print(compare(a, b))
        return 0
    if not args.jsonl:
        ap.error("need a JSONL path (or --compare A B)")
    print(render(summarize(_load(args.jsonl), args.last)))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:       # `... | head` closed the pipe: fine
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    raise SystemExit(code)
