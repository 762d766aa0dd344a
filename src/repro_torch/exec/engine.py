"""The chunked execution engine (paper scale).

  * ``ChunkRunner`` drives rounds in chunks through
    ``core.round.make_train_loop``: the chunk's batches and schedules
    cross to the device once, the rounds run back to back with no host
    sync, and the per-round metrics come back once at the chunk's end.
    ``use_scan=False`` replays the identical rounds one at a time (the
    ``--no-scan`` configuration), bit-identical to the chunked run.
    ``per_round_batch=False`` feeds one batch to every round (the pod
    path). Under the partitioned client plane it stages the chunk's
    ``data.pipeline.partition_plan`` into the schedule first, so the
    chunked loop and the per-round fallback replay the same dispatch.
  * ``SimulationEngine`` adds the data plane (``data.pipeline
    .stage_chunk``: one gather per chunk of rounds, the next chunk staged
    on a host thread by ``ChunkPrefetcher`` while the card runs the
    current one), evaluation at an ``eval_every`` cadence
    (``exec.evals.Evaluator``), checkpoints of the full round state
    ``{params, t, aux}`` (``save``/``resume``, bitwise continuation),
    the telemetry hooks (``obs.timing.PhaseTimes`` phases, an optional
    ``obs.log.MetricsLogger``) and the ``History`` stability metrics.

Both take a ``mesh`` (``launch.mesh.engine_mesh``), as the JAX
engine's do: the runner dispatches under it (``sharding.ctx.use``), so
the round splits the client axis over the ranks; it copies only the
rank's cohort block of a batch to the device, and under the partitioned
client plane builds the rank's partition plan over that block. The
simulation engine stages only those cohorts (every rank computes the
whole schedule from the seed: a dense one, or the hashed schedule of a
virtual population, O(C) a round either way), and only rank 0
evaluates, logs and writes checkpoints (the comm plane's residual
gathered from every rank first). Without a mesh (or with the degenerate
one) nothing changes.

The server rule is a ``ServerStrategy`` and the world an
``Environment``; the engine owns only data movement, chunking and
evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import env as env_mod
from repro_torch.checkpoint.io import restore_state, save_state
from repro_torch.configs.base import FLConfig
from repro_torch.core import strategies
from repro_torch.core.round import (as_scan_scheds, init_state,
                                   make_train_loop)
from repro_torch.data.pipeline import (ChunkPrefetcher, partition_plan,
                                      stage_chunk)
from repro_torch.exec.evals import Evaluator
from repro_torch.obs.metrics import payload_bytes, stability_stats
from repro_torch.obs.timing import PhaseTimes, annotate
from repro_torch.sharding import ctx
from repro_torch.utils.device import resolve_device


@dataclass
class History:
    """Per-run metric record. ``test_acc[i]`` was measured after
    ``eval_rounds[i]`` rounds (absolute indices), so the stability
    window is a span of ROUNDS whatever the eval cadence."""

    test_acc: list = field(default_factory=list)
    test_loss: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    eval_rounds: list = field(default_factory=list)

    def stability_variance(self, last: int = 50) -> float:
        """Paper's stability metric: variance of test accuracy over the
        last ``last`` ROUNDS (in percentage points squared)."""
        return stability_stats(self.eval_rounds, self.test_acc,
                               last)["stability_variance"]

    def final_accuracy(self, last: int = 50) -> float:
        return stability_stats(self.eval_rounds, self.test_acc,
                               last)["final_accuracy"]


class ChunkRunner:
    """N rounds per call on the device: chunked, or one round at a time
    (``use_scan=False``) through the same loop.

    ``per_round_batch=True`` (paper scale) takes a fresh (n, C, steps, b,
    ...) batch row per round; ``False`` (pod scale) re-feeds one (C,
    steps, b, ...) batch every round.

    Each dispatch books its wall time, closed by a CUDA sync, in
    ``timer``: the first dispatch of a chunk length under "compile" (in
    the port: the kernel library's build and load, cuDNN's set-up and
    the first execution), later ones under "scan_dispatch" (a chunk) or
    "round_dispatch" (one round).

    ``limited_split`` (None off the partitioned plane) counts, over the
    chunks run, the limited cohort-rounds that ran the limited program
    and those that overflowed to the masked one (the chunk's limited
    width is its least limited count; a 1-round chunk has none).

    ``mesh`` (a ``launch.mesh.FLMesh``) splits the client axis over its
    ranks: a batch given with all C cohorts is cut to the rank's block
    before it is copied to the device, and ``collective`` counts the
    bytes the round's collectives brought this rank (their seconds are
    the timer's "collective" phase). Under the partitioned plane each
    rank's plan is ``partition_plan`` of its own block of the chunk's
    ``limited`` (its limited width is its block's least limited count,
    so a cohort may take another program than in one process), and
    ``limited_split`` counts every client shard's plan once (every rank
    holds the whole schedule, so it needs no collective)."""

    def __init__(self, model, fl: FLConfig, strategy=None, *,
                 per_round_batch: bool = True, use_scan: bool = True,
                 device=None, timer=None, mesh=None):
        self.fl = fl
        self.mesh = mesh
        self.collective = ctx.CollectiveStats()
        self.device = resolve_device(device)
        self.per_round_batch = per_round_batch
        self.use_scan = use_scan
        self._loop = make_train_loop(model, fl,
                                     strategy or strategies.resolve(fl),
                                     per_round_batch=per_round_batch)
        self.timer = timer if timer is not None else PhaseTimes()
        self._seen: set = set()
        self.limited_split = ({"limited_program": 0, "overflow": 0}
                              if fl.client_plane == "partitioned"
                              and not fl.fes_static else None)

    def _blocks(self, C: int) -> list:
        """Every client shard's cohort slots, in shard order."""
        mesh = self.mesh
        if mesh is None or mesh.client == 1:
            return [slice(0, C)]
        n = C // mesh.client
        return [slice(s * n, (s + 1) * n) for s in range(mesh.client)]

    def _dispatch(self, state, batch, scheds, n: int):
        phase = ("compile" if n not in self._seen
                 else ("scan_dispatch" if n > 1 else "round_dispatch"))
        self._seen.add(n)
        with self.timer.phase(phase) as span, annotate(f"train_chunk_n{n}"), \
                ctx.use(self.mesh, self.timer, self.collective):
            out = self._loop(state, batch, scheds)
            span.sync(out)
        return out

    def run_chunk(self, state, batch: dict, sched_batch: dict, *,
                  scan_ok: bool = True):
        """(state, batch, Environment.batch dict) -> (state, metrics).
        ``batch`` leaves (numpy or tensors) are (n, C, steps, b, ...) when
        ``per_round_batch``, else (C, steps, b, ...), with all C cohorts
        or, under a mesh, the rank's block of them; metrics come back as
        numpy arrays with a leading (n,) axis. ``scan_ok=False`` runs the
        chunk one round at a time."""
        if (self.limited_split is not None
                and "part_src_row" not in sched_batch):
            # the plan is chunk-level, so the chunked loop and the
            # per-round fallback replay the identical dispatch; under a
            # split client axis each shard's plan addresses its own slots
            limited = np.asarray(sched_batch["limited"])
            plans = [partition_plan(limited[:, b])
                     for b in self._blocks(limited.shape[1])]
            shard = self.mesh.shard if len(plans) > 1 else 0
            sched_batch = {**sched_batch, **plans[shard]}
            n_lim = sum(p["part_lim_idx"].size for p in plans)
            self.limited_split["limited_program"] += n_lim
            self.limited_split["overflow"] += int(np.sum(limited)) - n_lim
        scheds = as_scan_scheds(sched_batch, self.device)
        with ctx.use(self.mesh):
            batch = ctx.constrain_leading(batch, scheds["limited"].shape[1],
                                          dim=int(self.per_round_batch))
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        n = scheds["limited"].shape[0]
        if self.use_scan and scan_ok:
            state, metrics = self._dispatch(state, batch, scheds, n)
        else:
            rows = []
            for r in range(n):
                b = ({k: v[r:r + 1] for k, v in batch.items()}
                     if self.per_round_batch else batch)
                state, m = self._dispatch(
                    state, b, {k: v[r:r + 1] for k, v in scheds.items()}, 1)
                rows.append(m)
            metrics = {k: torch.cat([m[k] for m in rows]) for k in rows[0]}
        return state, {k: v.cpu().numpy() for k, v in metrics.items()}


class SimulationEngine:
    """Paper-scale federated simulation on the chunked engine: schedules
    from ``Environment.batch``, client batches staged in one gather per
    chunk (the next chunk on a host thread while the card runs the
    current one, ``fl.prefetch_depth`` chunks ahead; 0 stages inline),
    evaluation through the batched ``Evaluator``. ``clients`` is a dense
    ``list[ClientDataset]`` or a ``data.pipeline.VirtualClientShards``
    (a million-client population, nothing O(K) on the host). ``logger``
    (an ``obs.log.MetricsLogger``) receives the header, the per-round
    rows, the eval points and the phase summary. Under ``mesh`` each
    rank stages its own cohort block, and only rank 0 evaluates (other
    ranks' ``History`` has the train losses only), logs and writes."""

    def __init__(self, model, fl: FLConfig, clients, test_data,
                 use_scan: bool = True, device=None, logger=None,
                 mesh=None):
        self.model = model
        self.fl = fl
        self.mesh = mesh
        self.writer = mesh is None or mesh.writer
        self.device = resolve_device(device)
        # clients: a dense list[ClientDataset] OR a VirtualClientShards
        # (streamed K-free staging: client shards are arithmetic views of
        # one base store, nothing materialised per client)
        self.clients = clients
        self._streamed = hasattr(clients, "shard_indices")
        self.test_data = test_data
        # the |D_i| aggregation weights: a dense (K,) vector for a client
        # list, a callable for virtual shards (no K-long array)
        self.env = env_mod.resolve(
            fl, data_sizes=(clients.client_sizes if self._streamed else
                            np.array([len(c) for c in clients],
                                     np.float32)))
        self.strategy = strategies.resolve(fl)
        # one PhaseTimes spans the runner, the data plane, evaluation and
        # checkpoints
        self.timer = PhaseTimes()
        self.logger = logger if self.writer else None
        self.runner = ChunkRunner(model, fl, self.strategy,
                                  use_scan=use_scan, device=self.device,
                                  timer=self.timer, mesh=mesh)
        # this rank's cohort slots (all of them without a split)
        self._block = (mesh.cohorts(fl.clients_per_round)
                       if mesh is not None and mesh.client > 1 else None)
        self._evaluator = Evaluator(model, test_data, device=self.device)
        self.data = clients.data if self._streamed else clients[0].data
        if not self._streamed and any(c.data is not self.data
                                      for c in clients):
            raise ValueError(
                "the chunked data plane stages every client from ONE "
                "shared sample store (build clients with "
                "data.pipeline.build_clients(data, partition))")
        gen = torch.Generator().manual_seed(fl.seed)
        self.state = init_state(model, fl, gen, self.device, self.strategy,
                                mesh=mesh)

    # engine state — the full round carry {params, t, aux} ---------------
    @property
    def params(self):
        return self.state["params"]

    @property
    def t(self) -> int:
        return int(self.state["t"])

    @property
    def aux(self):
        return self.state["aux"]

    def save(self, path: str) -> None:
        """Checkpoint the whole round state (params, round index, aux:
        ring buffer, fedopt moments, comm residuals); under a mesh rank 0
        writes it, the residual gathered from every rank's block, and
        every rank waits for it: the file a one-process run writes."""
        with self.timer.phase("checkpoint"):
            save_state(path, self.state, mesh=self.mesh)

    def resume(self, path: str) -> None:
        """Restore {params, t, aux} onto this engine's device. Staging,
        schedules and the comm noise are pure in t, so the next chunk
        continues bitwise where the checkpointed run left off. Under a
        mesh each rank takes its block of the comm residual."""
        self.state = restore_state(path, self.state, mesh=self.mesh)

    def _steps_per_round(self) -> int:
        n_min = (self.clients.min_size if self._streamed
                 else min(len(c) for c in self.clients))
        per_epoch = max(1, n_min // self.fl.local_batch_size)
        return self.fl.local_epochs * per_epoch

    def _stage(self, t0: int, n: int):
        # on the prefetcher's worker thread when prefetching: its
        # "stage" seconds overlap the device phases by design
        with self.timer.phase("stage"), annotate(f"stage_t{t0}"):
            sb = self.env.batch(t0, n)
            batch = stage_chunk(self.data, self.clients, sb["selected"],
                                self.fl.seed, t0, self._steps_per_round(),
                                self.fl.local_batch_size,
                                cohorts=self._block)
        return sb, batch

    def run_round(self) -> float:
        """One round through the engine (a chunk of 1, the per-round
        path); returns its mean client loss."""
        sb, batch = self._stage(self.t, 1)
        self.state, metrics = self.runner.run_chunk(self.state, batch, sb,
                                                    scan_ok=False)
        return float(metrics["loss"][0])

    def evaluate(self) -> tuple[float, float]:
        with self.timer.phase("eval"), annotate("eval"):
            return self._evaluator(self.state["params"])

    def run(self, rounds: int | None = None, eval_every: int = 1,
            verbose: bool = False) -> History:
        hist = History()
        rounds = rounds or self.fl.rounds
        t0, end = self.t, self.t + rounds
        if self.logger is not None:
            self.logger.header(self.fl, payload=payload_bytes(self.params),
                               resumed_at=t0 if t0 else None,
                               extra={"device": str(self.device)},
                               mesh=self.mesh)
        # chunk boundaries sit on ABSOLUTE multiples of eval_every, so a
        # resumed run evaluates at the same global rounds as the
        # uninterrupted run it continues
        chunks, t = [], t0
        while t < end:
            n = min((t // eval_every + 1) * eval_every, end) - t
            chunks.append((t, n))
            t += n
        depth = self.fl.prefetch_depth
        staged = (ChunkPrefetcher(lambda c: self._stage(*c), chunks,
                                  depth=depth) if depth > 0
                  else (self._stage(*c) for c in chunks))
        try:
            for (t, n), (sb, batch) in zip(chunks, staged):
                self.state, metrics = self.runner.run_chunk(
                    self.state, batch, sb, scan_ok=(n == eval_every))
                hist.train_loss.extend(float(x) for x in metrics["loss"])
                if self.logger is not None:
                    self.logger.rounds(t, metrics)
                if (t + n) % eval_every == 0 and self.writer:
                    # partial chunks: no eval
                    acc, loss = self.evaluate()
                    hist.test_acc.append(acc)
                    hist.test_loss.append(loss)
                    hist.eval_rounds.append(t + n)
                    if self.logger is not None:
                        self.logger.eval(t + n, acc, loss)
                    done = t + n - t0
                    if verbose and done % 10 == 0:
                        print(f"  round {done:4d} "
                              f"train_loss={hist.train_loss[-1]:.4f} "
                              f"test_acc={acc:.4f}")
        finally:
            if isinstance(staged, ChunkPrefetcher):
                staged.close()           # abandoned mid-run: release the
            if self.logger is not None:  # worker and the buffered chunks
                self.logger.phases(self.timer)
        return hist
