"""A cell of the benchmark, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic; the files are found by those names:

  * ``portbench/configs/<config>.json``: the model's sizes (the port's
    ``ModelConfig`` fields; ``source``, ``reduced``, ``assumed`` and
    ``deployment`` beside them);
  * ``portbench/traffic/<traffic>.json``: the mix ``traffic.py`` reads;
  * ``portbench/workloads/<cell>.json``: the cell's limits;
  * ``portbench/end_to_end/<metric>.py`` and
    ``portbench/layer_metrics/<metric>.py``: one reader a metric.

Adding a configuration, a traffic mix, a cell or a metric is adding its
file and its entry; no existing file changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries that the cell reports
    per_layer: list


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"], cfg=_json(root / entry["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(kind: str, metric: str):
    """The ``read(run)`` of ``portbench/<kind>/<metric>.py``."""
    path = HERE / kind / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', metric)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
