"""The port's telemetry plane: the JSONL rows of ``--metrics-out``
(checked by both packages' validators and reported by both report
CLIs), the phase timers and the profiler hooks, provenance, and the
tail of a resumed run's file."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.partition import shard_partition
from repro.data.synth import make_image_classification
from repro.obs import log as jlog
from repro.obs import report as jreport
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.models.api import build_model as tbuild
from repro_torch.obs import log as tlog
from repro_torch.obs import provenance as tprov
from repro_torch.obs import report as treport
from repro_torch.obs.metrics import ROUND_METRIC_KEYS
from repro_torch.obs.timing import PhaseTimes, annotate, profile_trace, sync_time

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one machine; at these tiny
    shapes torch's intra-op thread pool in each worker would only
    oversubscribe the cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    return train, test, shard_partition(train["label"], 8, seed=0)


def _fl(**kw):
    base = dict(num_clients=8, clients_per_round=4, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.5,
                algorithm="async_ama", max_delay=3, p_delay=0.4, seed=0,
                extended_metrics=True)
    return TFL(**{**base, **kw})


def _run(world, path, rounds, fl=None, resume=None, **kw):
    train, test, part = world
    logger = tlog.MetricsLogger(path)
    sim = TSim(tbuild(TARCHS["paper-cnn"]), fl or _fl(**kw),
               tbuild_clients(train, part), test, device="cpu",
               logger=logger)
    if resume:
        sim.resume(resume)
    hist = sim.run(rounds=rounds, eval_every=3)
    logger.close()
    return sim, hist


@pytest.mark.parametrize("server_plane", ["fused", "legacy"])
def test_port_jsonl_validates_in_both_packages_and_reports(
        world, tmp_path, server_plane):
    path = str(tmp_path / "run.jsonl")
    sim, hist = _run(world, path, 6, server_plane=server_plane,
                     use_kernel=server_plane == "legacy")
    rows = tlog.read_rows(path)
    assert tlog.validate_rows(rows) == []
    assert jlog.validate_rows(jlog.read_rows(path)) == []
    head = rows[0]
    assert head["kind"] == "header" and head["schema"] == 3
    assert head["provenance"]["torch_version"] == torch.__version__
    assert head["config"]["server_plane"] == server_plane
    assert head["payload_bytes"] == 54_784 * 4 and head["device"] == "cpu"
    rnd = [r for r in rows if r["kind"] == "round"]
    assert [r["t"] for r in rnd] == [1, 2, 3, 4, 5, 6]
    for r in rnd:
        assert set(ROUND_METRIC_KEYS) <= set(r)
        assert len(r["stale_hist"]) == 4
    assert rnd[0]["alpha_eff"] > 0 and rnd[0]["compression_ratio"] == 1.0
    assert [r["t"] for r in rows if r["kind"] == "eval"] == [3, 6]
    assert rows[-1]["kind"] == "phases"
    assert {"stage", "compile", "eval"} <= set(rows[-1]["phases"])
    # both report CLIs reproduce the engine's History exactly
    for rep in (treport, jreport):
        s = rep.summarize(rows)
        assert s["final_accuracy"] == hist.final_accuracy()
        assert s["stability_variance"] == hist.stability_variance()
        assert s["rounds"] == 6 and s["stale_hist"]
    back = treport.history_from_rows(rows)
    assert back.eval_rounds == hist.eval_rounds
    assert back.train_loss == pytest.approx(hist.train_loss, rel=1e-7)


def test_report_cli_and_compare(world, tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _run(world, a, 3)
    _run(world, b, 3, algorithm="fedavg", max_delay=0, p_delay=0.0)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", a],
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "run: algorithm=async_ama" in p.stdout
    assert "staleness: hist=" in p.stdout and "rounds/s" in p.stdout
    p = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                        "--compare", a, b], capture_output=True, text=True,
                       env=env, timeout=120)
    assert p.returncode == 0 and "-- deltas (B - A) --" in p.stdout
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "round", "t": 1}) + "\n")
    p = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                        str(bad)], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 2 and "SCHEMA ERROR" in p.stderr


def test_resumed_run_rows_equal_the_uninterrupted_tail(world, tmp_path):
    """Round and eval rows are pure in the round they describe: the rows
    of a run resumed at round 3 equal rows 4..6 of the whole run."""
    whole = str(tmp_path / "whole.jsonl")
    _run(world, whole, 6)
    first, _ = _run(world, str(tmp_path / "first.jsonl"), 3)
    first.save(str(tmp_path / "ck.npz"))
    tail = str(tmp_path / "tail.jsonl")
    _run(world, tail, 3, resume=str(tmp_path / "ck.npz"))
    w, t = tlog.read_rows(whole), tlog.read_rows(tail)
    assert t[0]["resumed_at"] == 3 and w[0]["resumed_at"] is None
    pick = lambda rows: [r for r in rows if r["kind"] in ("round", "eval")]
    assert pick(t) == [r for r in pick(w) if r["t"] > 3]


def test_phase_times_sync_time_and_profile_trace(tmp_path):
    times = PhaseTimes()
    with times.phase("stage") as span:
        span.sync({"x": [torch.ones(3)]})
    with times.phase("stage"):
        pass
    s = times.summary()
    assert list(s) == ["stage"] and s["stage"]["calls"] == 2
    assert times.total() == pytest.approx(s["stage"]["seconds"], abs=1e-5)
    dt, out = sync_time(lambda a: a * 2, torch.ones(2))
    assert dt >= 0 and torch.equal(out, torch.full((2,), 2.0))
    with profile_trace(str(tmp_path / "prof")):
        with annotate("round_of_interest"):
            torch.ones(64).sum()
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "round_of_interest" in trace
    with profile_trace(None) as prof:
        assert prof is None


def test_provenance_names_torch_and_the_device():
    p = tprov.provenance()
    assert p["torch_version"] == torch.__version__
    assert p["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert {"git_sha", "host", "python", "cuda_version"} <= set(p)
    q = dict(p, torch_version="0.0")
    assert tprov.diff(p, q) == [f"torch_version: {p['torch_version']} -> 0.0"]
    assert tprov.diff(p, None) == []
    assert np.isfinite(p["generated_unix"])


def test_phase_times_keep_every_add_under_thread_contention():
    """The prefetcher's worker and the main thread add to one PhaseTimes:
    no lost update under many threads and a short switch interval."""
    import threading
    times = PhaseTimes()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [times.add("stage", 1.0) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    s = times.summary()["stage"]
    assert s["calls"] == n_threads * n_adds
    assert s["seconds"] == float(n_threads * n_adds)
