"""Federated training launcher for the PyTorch/CUDA port.

Two configurations of one engine (``repro_torch.exec``):
  * paper scale (default): K simulated clients over the synthetic non-iid
    shards, the paper's §V experiment with its heterogeneity knobs,
    driven in ``--eval-every`` round chunks through the chunked engine;
  * ``--pod``: C cohorts of a decoder LM (``--arch minitron-8b``) each
    take ``--local-steps`` local SGD steps on their own token streams
    (``data/synth.py: make_lm_tokens``), and the same fused server plane
    aggregates them: the paper's FL at LLM scale. The whole run is one
    chunk of ``--rounds`` rounds re-feeding one batch (``--no-scan``: one
    round at a time, bit-identical); attention runs on the hand-written
    flash-attention kernels, forward and backward. ``--reduced`` takes
    the JAX package's CPU-sized variant of the architecture.

``--no-scan`` runs the same rounds one at a time (bit-identical). The run is on the GPU unless
``--device cpu`` asks for the CPU; on the GPU the server update of
every round is one hand-written CUDA kernel call (``--server-plane
ref`` runs the plain PyTorch version instead). ``--comm-plane`` compresses
the client uplink (bf16, q8, top-k with error feedback) and the server
consumes the compressed payload in-kernel; ``--env bandwidth`` prices the
(compressed) upload against a round deadline.

``--server-plane legacy`` runs the pre-fusion per-leaf server chain
instead (``core/ama.py``); with ``--use-kernel`` its mix is the
hand-written ``ama_mix`` kernel, one launch a round for all the leaves
of a dtype pair.
``--checkpoint`` saves and ``--resume`` restores the full round state
{params, t, aux}, in the JAX package's npz layout, so continuation is
bitwise. ``--prefetch-depth`` sets how many chunks a host thread stages
ahead of the card (0: inline). ``--metrics-out run.jsonl`` turns on the
telemetry plane (per-round staleness, participation, mix, norm and wire
series as schema-3 JSONL, summarized by ``python -m
repro_torch.obs.report run.jsonl``); ``--profile DIR`` writes a
``torch.profiler`` trace of the run into DIR. ``--client-reduce force``
pre-reduces the client axis before the server update.

``--client-plane partitioned`` groups each round's cohorts by FES
limited-ness into two programs (both scales): the limited ones never
build the body backward (paper Eq. 3), where the default masked plane
computes it and zeroes it. Under chunks of several rounds the limited
program's width is the chunk's least limited count and the rest
overflow to the masked program; the run ends with a line counting
both (``--no-scan`` on the pod path gives the exact per-round split).
``FLConfig(fes_static=True)`` (through ``paper_scale`` / ``pod_scale``)
trains every cohort classifier-only.

Under ``torchrun --standalone --nproc-per-node W`` both scales split each
round's cohorts over the W ranks (``launch.mesh.engine_mesh``: client
width = the widest divisor of W and the cohort count, the JAX package's
rule), NCCL when each rank has a card of its own, gloo when they share
one or run with ``--device cpu``. Each rank trains and stages its own
cohort block; the rows are all-gathered before the server kernel, or
with ``--client-reduce`` pre-reduced ("auto": when the client width is
above 1). With ``--comm-plane`` each rank compresses its own rows and,
gathered, the compressed payload travels; pre-reduced, each rank
reconstructs its rows and f32 partial sums travel. Under
``--client-plane partitioned`` each rank plans its own block, and
``--population virtual`` stages each rank's block of the hashed
schedule. Every rank keeps the same server state (the comm residual
aside: each rank holds its block, gathered for ``--checkpoint``); rank
0 prints, evaluates and writes ``--checkpoint``, ``--metrics-out`` and
``--profile``. The launcher takes no flag for it: W comes from torchrun.

``--env`` takes any registered environment (bernoulli, gilbert_elliott,
bandwidth, trace and their aliases); ``--scenario`` applies a named
environment + knob binding after the other flags (an explicit
``--trace-path`` still wins over the scenario's own). ``--population``
picks the population's realisation: ``auto`` keeps the dense path up
to 65,536 clients and the K-free virtual population above, where the
clients are arithmetic shard views of one store (``VirtualClientShards``)
and nothing on the host is K long; pass ``--clients-per-round`` there
(the default K/4 is no cohort the card's server kernels take).

Examples:
  python -m repro_torch.launch.train --rounds 60 --p-limited 0.5 --eval-every 5
  python -m repro_torch.launch.train --algorithm fedavg --rounds 60
  python -m repro_torch.launch.train --algorithm fedopt --rounds 60
  python -m repro_torch.launch.train --comm-plane q8 --rounds 60
  python -m repro_torch.launch.train --client-plane partitioned --p-limited 0.5 --eval-every 1
  python -m repro_torch.launch.train --p-delay 0.3 --max-delay 10 --rounds 30
  python -m repro_torch.launch.train --env bandwidth --max-delay 5 --comm-plane q8
  python -m repro_torch.launch.train --algorithm async_ama --scenario bursty-severe --rounds 30
  python -m repro_torch.launch.train --scenario mobility-trace --trace-path trace.npz
  python -m repro_torch.launch.train --clients 1000000 --clients-per-round 32 --population auto
  python -m repro_torch.launch.train --server-plane legacy --use-kernel
  python -m repro_torch.launch.train --rounds 10 --checkpoint ck.npz
  python -m repro_torch.launch.train --rounds 10 --resume ck.npz
  python -m repro_torch.launch.train --metrics-out run.jsonl --rounds 20
  python -m repro_torch.launch.train --device cpu --rounds 2
  python -m repro_torch.launch.train --arch minitron-8b --pod --reduced --rounds 3
  python -m repro_torch.launch.train --arch minitron-8b --pod --reduced --rounds 2 --device cpu
  python -m repro_torch.launch.train --arch rwkv6-3b --pod --reduced --client-plane partitioned --no-scan
  python -m repro_torch.launch.train --arch zamba2-1.2b --pod --reduced --rounds 2 --device cpu
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --clients 50 --clients-per-round 10 --device cpu
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --clients 50 --clients-per-round 10 --comm-plane q8 --client-reduce off
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --clients 50 --clients-per-round 10 --client-plane partitioned --p-limited 0.5
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --clients 1000000 --clients-per-round 10 --population virtual
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch import env as env_mod
from repro_torch.checkpoint.io import restore_state, save_state
from repro_torch.configs.base import FLConfig, ModelConfig, reduced
from repro_torch.configs.registry import (ARCHS, environment_names,
                                         get_arch, get_scenario,
                                         scenario_names)
from repro_torch.core import strategies
from repro_torch.core.fes import count_trainable
from repro_torch.core.round import init_state
from repro_torch.core.simulation import FederatedSimulation
from repro_torch.data.partition import shard_partition
from repro_torch.data.pipeline import VirtualClientShards, build_clients
from repro_torch.data.synth import make_image_classification, make_lm_tokens
from repro_torch.env.virtual import is_virtual
from repro_torch.exec.engine import ChunkRunner
from repro_torch.launch.mesh import engine_mesh
from repro_torch.models.api import build_model
from repro_torch.obs.log import MetricsLogger
from repro_torch.obs.metrics import payload_bytes
from repro_torch.obs.timing import profile_trace, sync_time
from repro_torch.sharding import ctx
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaves as tree_leaves


def _quiet(*args, **kwargs) -> None:
    """``print`` on ranks other than 0."""


def reckoned_bytes(fl: FLConfig, mesh, params, strategy,
                   C: int) -> tuple[str, int]:
    """(route, bytes): the client axis' route under ``mesh`` and the
    bytes one rank receives through it a round, the per-cohort losses
    aside (``sharding.ctx.round_bytes``)."""
    reduced = ctx.pre_reduced(fl, mesh)
    plane = comm.resolve(fl)
    queue = strategy.init_state(params).get("queue")
    R = 1 + queue["gamma"].shape[0] if reduced and queue else 1
    n = sum(x.numel() for x in tree_leaves(params))
    payload = (plane.payload_bytes(params) if plane is not None
               else payload_bytes(params))
    nbytes = ctx.round_bytes(mesh, C, payload, n, R, reduced)
    if reduced:
        route = "pre-reduced (a rank-ordered sum of f32 partials"
        route += (f"; each rank reconstructs its rows from its "
                  f"{fl.comm_plane} payload, so the partials travel, not "
                  "the payloads)" if plane is not None else ")")
    elif plane is not None:
        route = (f"{fl.comm_plane} payload gathered compressed ({payload:,} "
                 "bytes a cohort) before the server kernel")
    else:
        route = "gathered before the server kernel"
    return route, nbytes


def _mesh_line(fl: FLConfig, mesh, params, strategy, C: int) -> str:
    """The run's mesh, the client axis' route and its bytes a round
    ("" without a process group)."""
    if mesh.group is None:
        return ""
    route, nbytes = reckoned_bytes(fl, mesh, params, strategy, C)
    return (f"{mesh.describe()}; rank {mesh.rank} trains cohorts "
            f"{mesh.cohorts(C).start}..{mesh.cohorts(C).stop - 1} of {C}; "
            f"client axis {route} (client_reduce {fl.client_reduce}): "
            f"{nbytes:,} bytes a round received per rank")


def _print_phases(timer) -> None:
    summary = timer.summary()
    if summary:
        print("phases: " + "  ".join(
            f"{k}={v['seconds']:.2f}s/{v['calls']}"
            for k, v in summary.items()))


def _client_plane(fl: FLConfig) -> str:
    return "fes_static" if fl.fes_static else fl.client_plane


def _print_limited_split(runner) -> None:
    """The partitioned plane's limited cohort-rounds: on the limited
    program, and overflowed to the masked one; under a split client axis
    summed over the client shards, each planned over its own block."""
    split = runner.limited_split
    if split is not None:
        mesh = runner.mesh
        over = (f" (summed over {mesh.client} client shards, one replica "
                "each, each shard planning its own block)"
                if mesh is not None and mesh.client > 1 else "")
        print(f"client plane partitioned: {split['limited_program']} limited "
              f"cohort-rounds on the limited program, {split['overflow']} "
              f"overflowed to the masked program{over}")


def _shards(clients) -> str:
    if isinstance(clients, VirtualClientShards):
        return (f" (streamed shards of {clients.shard_size} over a store "
                f"of {clients.n})")
    return ""


def paper_scale(args, fl: FLConfig, device):
    """Run the §V experiment; returns (simulation, History). Under
    torchrun the cohorts split over the ranks (``engine_mesh``); only
    rank 0 evaluates, prints and writes."""
    model = build_model(get_arch(args.arch))
    train, test = make_image_classification(
        n_train=args.n_train, n_test=400, seed=fl.seed)
    if is_virtual(fl):
        # virtual population: clients are arithmetic shard views of the
        # base store; nothing materialised per client, any K
        clients = VirtualClientShards(
            train, fl.num_clients,
            shard_size=max(fl.local_batch_size,
                           args.n_train // min(fl.num_clients, 64)),
            seed=fl.seed)
    else:
        clients = build_clients(
            train,
            shard_partition(train["label"], fl.num_clients, seed=fl.seed))
    mesh = engine_mesh(fl.clients_per_round, device)
    say = print if mesh.writer else _quiet
    logger = (MetricsLogger(args.metrics_out)
              if args.metrics_out and mesh.writer else None)
    sim = FederatedSimulation(model, fl, clients, test,
                              use_scan=not args.no_scan, device=device,
                              logger=logger, mesh=mesh)
    n_clf, n_all = count_trainable(sim.params, model.fes_mask(sim.params))
    say(f"{args.arch} on {device}: {n_all} params ({n_clf} in the FES "
        f"classifier); {fl.algorithm} -> "
        f"{type(sim.strategy).__name__}, server plane {fl.server_plane}"
        f"{' (ama_mix kernel)' if fl.use_kernel else ''}, "
        f"client plane {_client_plane(fl)}, comm plane {fl.comm_plane}, "
        f"env {fl.env}, population "
        f"{'virtual' if sim.env.virtual else 'dense'} of {fl.num_clients}"
        f"{_shards(clients)}")
    line = _mesh_line(fl, mesh, sim.params, sim.strategy,
                      fl.clients_per_round)
    if line:
        say(line)
    if args.resume:
        sim.resume(args.resume)
        say(f"resumed {args.resume} at round {sim.t}")
    try:
        with profile_trace(args.profile if mesh.writer else None):
            hist = sim.run(rounds=args.rounds, eval_every=args.eval_every,
                           verbose=mesh.writer)
    finally:
        if logger is not None:
            logger.close()
    say(f"final: acc={hist.final_accuracy():.4f} "
        f"stability_var={hist.stability_variance():.3f}")
    if mesh.writer:
        _print_limited_split(sim.runner)
        _print_phases(sim.timer)
    if args.checkpoint:
        sim.save(args.checkpoint)
        say(f"saved {args.checkpoint} (full round state, t={sim.t})")
    if args.profile:
        say(f"profile -> {args.profile}/trace.json")
    if logger is not None:
        print(f"metrics -> {args.metrics_out} "
              f"(python -m repro_torch.obs.report {args.metrics_out})")
    return sim, hist


def _pod_batch(cfg: ModelConfig, fl: FLConfig, args):
    """{"tokens": (C, steps, b, S) int32}: C x steps x b Markov token
    streams of S + 1 tokens over C topics (the last token is dropped, as
    in the JAX package). The audio family adds ``frame_emb`` (C, steps,
    b, encoder_seq, d_model), zeros in the model dtype as JAX's pod batch
    has them (the frontend is a stub; ``enc_pos`` is added to them). The
    vlm family adds ``patch_emb`` (C, steps, b, num_patches, vision_dim)
    in the model dtype, drawn N(0, 1) from the seed where JAX's pod batch
    has zeros: zero patches stay zero rows through every block, and
    RMSNorm's backward at a zero row scales the gradient by rsqrt(eps) =
    1000 a layer, so at the config's 32 layers the gradient overflows to
    NaN, in the JAX package as in the port (f32 or bf16)."""
    C, steps, b, S = fl.cohorts, fl.local_steps, args.batch, args.seq
    data = make_lm_tokens(C * steps * b, S + 1, cfg.vocab_size,
                          n_topics=C, seed=fl.seed)
    batch = {"tokens": np.ascontiguousarray(
        data["tokens"][:, :S].reshape(C, steps, b, S))}
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        pe = np.random.RandomState(fl.seed).standard_normal(
            (C, steps, b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
        batch["patch_emb"] = torch.from_numpy(pe).to(dtype)
    if cfg.family == "audio":
        batch["frame_emb"] = torch.zeros(
            (C, steps, b, cfg.encoder_seq, cfg.d_model), dtype=dtype)
    return batch


def pod_scale(args, fl: FLConfig, device, cfg: ModelConfig | None = None):
    """C cohorts of a decoder LM, one chunk of ``args.rounds`` rounds
    (per round with ``args.no_scan``). ``cfg`` overrides ``--arch`` /
    ``--reduced`` (a depth-cut full-width config, say). Returns (state,
    metrics {"loss", "n_on_time"} as numpy (rounds,), the training
    seconds closed by a device sync). Under torchrun the cohorts split
    over the ranks (``engine_mesh``), each rank copying only its block
    of the batch to its device; every rank reads ``--resume``, and rank
    0 prints and writes."""
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    model = build_model(cfg)
    # the stacked client axis is the cohort count: align the config so
    # comm-plane residual state (sized by fl.clients_per_round) matches
    fl = fl.with_(clients_per_round=fl.cohorts)
    C = fl.cohorts
    mesh = engine_mesh(C, device)
    say = print if mesh.writer else _quiet
    strategy = strategies.resolve(fl)
    state = init_state(model, fl, torch.Generator().manual_seed(fl.seed),
                       device, strategy, mesh=mesh)
    if args.resume:
        state = restore_state(args.resume, state, mesh=mesh)
        say(f"resumed {args.resume} at round {int(state['t'])}")
    environment = env_mod.resolve(fl.with_(num_clients=C,
                                           clients_per_round=C))
    batch = _pod_batch(cfg, fl, args)
    runner = ChunkRunner(model, fl, strategy, per_round_batch=False,
                         use_scan=not args.no_scan, device=device, mesh=mesh)
    n_clf, n_all = count_trainable(state["params"],
                                   model.fes_mask(state["params"]))
    S = batch["tokens"].shape[-1]
    say(f"{cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on "
        f"{device}: {n_all} params ({n_clf} in the FES classifier); "
        f"{fl.algorithm} -> {type(strategy).__name__}, client plane "
        f"{_client_plane(fl)}, {C} cohorts x {fl.local_steps} local steps "
        f"x batch {args.batch} x seq {S}")
    line = _mesh_line(fl, mesh, state["params"], strategy, C)
    if line:
        say(line)
    logger = (MetricsLogger(args.metrics_out)
              if args.metrics_out and mesh.writer else None)
    if logger is not None:
        logger.header(fl, payload=payload_bytes(state["params"]),
                      resumed_at=int(state["t"]) or None,
                      extra={"device": str(device), "arch": cfg.name},
                      mesh=mesh)
    t_start = int(state["t"])
    rows, dt = [], 0.0
    try:
        with profile_trace(args.profile if mesh.writer else None):
            if args.no_scan:
                for r in range(args.rounds):
                    tr, (state, m) = sync_time(
                        runner.run_chunk, state, batch,
                        environment.batch(t_start + r, 1), scan_ok=False)
                    dt += tr
                    rows.append(m)
                    if logger is not None:
                        logger.rounds(t_start + r, m)
                    say(f"round {r}: loss={float(m['loss'][0]):.4f} "
                        f"on_time={int(m['n_on_time'][0])}/{C} "
                        f"({tr:.2f}s)")
            else:
                dt, (state, m) = sync_time(
                    runner.run_chunk, state, batch,
                    environment.batch(t_start, args.rounds))
                rows.append(m)
                if logger is not None:
                    logger.rounds(t_start, m)
                for r in range(args.rounds):
                    say(f"round {r}: loss={m['loss'][r]:.4f} "
                        f"on_time={int(m['n_on_time'][r])}/{C}")
    finally:
        if logger is not None:
            logger.phases(runner.timer)
            logger.close()
    metrics = {k: np.concatenate([m[k] for m in rows]) for k in rows[0]}
    engine = "per-round loop" if args.no_scan else "one chunk"
    say(f"{args.rounds} rounds ({engine}): {dt:.2f}s total "
        f"({dt / args.rounds * 1e3:.1f} ms/round, first-call set-up "
        "included)")
    if mesh.writer:
        _print_limited_split(runner)
        _print_phases(runner.timer)
    if args.checkpoint:
        save_state(args.checkpoint, state, mesh=mesh)
        say(f"saved {args.checkpoint} (full round state, "
            f"t={int(state['t'])})")
    if args.metrics_out:
        say(f"metrics -> {args.metrics_out}")
    return state, metrics, dt


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="paper-cnn", choices=sorted(ARCHS))
    ap.add_argument("--algorithm", default="ama_fes",
                    choices=strategies.names())
    ap.add_argument("--env", default="bernoulli",
                    choices=environment_names(),
                    help="environment (channel/device/participation model)")
    ap.add_argument("--scenario", default=None, choices=scenario_names(),
                    help="named environment + config binding; overrides "
                         "--env and the delay knobs (an explicit "
                         "--trace-path still wins)")
    ap.add_argument("--trace-path", default="",
                    help="trace env: .npz schedule to replay "
                         "('' = synthetic mobility trace)")
    ap.add_argument("--population", default="auto",
                    choices=("auto", "dense", "virtual"),
                    help="population realisation: 'auto' keeps the dense "
                         "path up to 65536 clients and the K-free hashed "
                         "virtual population above; 'dense'/'virtual' "
                         "force either at any K")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="cohort size m (0 = clients/4, the paper ratio; "
                         "set it explicitly for large virtual populations)")
    ap.add_argument("--n-train", type=int, default=1500)
    ap.add_argument("--p-limited", type=float, default=0.25)
    ap.add_argument("--p-delay", type=float, default=0.0)
    ap.add_argument("--max-delay", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="eval cadence == chunk length")
    ap.add_argument("--server-plane", default="fused",
                    choices=("fused", "ref", "interpret", "legacy"),
                    help="server update: one fused CUDA kernel per round "
                         "(default), its plain PyTorch version, or the "
                         "pre-fusion per-leaf chain ('legacy'); "
                         "'interpret' is the JAX package's Pallas "
                         "interpreter and is refused")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the legacy chain's mix on the ama_mix CUDA "
                         "kernel (one launch per leaf); only meaningful "
                         "with --server-plane legacy")
    ap.add_argument("--client-reduce", default="auto",
                    choices=("auto", "off", "force"),
                    help="pre-reduce the stacked client axis before the "
                         "server update: 'auto' when torchrun's ranks "
                         "split it (client width above 1, the JAX rule), "
                         "'off' gathers the rows for the server kernel, "
                         "'force' always")
    ap.add_argument("--client-plane", default="masked",
                    choices=("masked", "partitioned"),
                    help="mixed-cohort client execution: one masked "
                         "program for every cohort (default; limited "
                         "cohorts compute the body backward and zero it) "
                         "or two programs grouped by FES limited-ness "
                         "(limited cohorts never build the body backward: "
                         "paper Eq. 3)")
    ap.add_argument("--comm-plane", default="none",
                    choices=("none", "bf16", "q8", "topk"),
                    help="compressed client->server uplink: dense f32 "
                         "(default), bf16 cast (2x), stochastic int8 (~4x) "
                         "or top-k sparsification, each with its "
                         "error-feedback residual in the round state")
    ap.add_argument("--comm-topk-frac", type=float, default=0.01,
                    help="topk plane: surviving fraction of each dtype "
                         "group per round")
    ap.add_argument("--no-scan", action="store_true",
                    help="run the rounds one at a time instead of in "
                         "chunks (bit-identical)")
    ap.add_argument("--prefetch-depth", type=int, default=1,
                    help="staged chunks a host thread keeps ahead of the "
                         "card (host memory ~ depth x chunk bytes; 0 "
                         "stages inline)")
    ap.add_argument("--metrics-out", default=None,
                    help="write schema-versioned telemetry JSONL here "
                         "(turns on the extended per-round metrics; "
                         "summarize with python -m repro_torch.obs.report)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run under torch.profiler and write the Chrome "
                         "trace to DIR/trace.json")
    ap.add_argument("--checkpoint", default=None,
                    help="save the full round state {params, t, aux} here "
                         "after the run")
    ap.add_argument("--resume", default=None,
                    help="restore a full round state before the run and "
                         "continue (bitwise as an uninterrupted run)")
    ap.add_argument("--pod", action="store_true",
                    help="LLM scale: C cohorts of --arch (a decoder LM) "
                         "train locally and the server plane aggregates "
                         "them; one chunk of --rounds rounds")
    ap.add_argument("--reduced", action="store_true",
                    help="pod: the CPU-sized variant of --arch")
    ap.add_argument("--cohorts", type=int, default=2,
                    help="pod: parallel client cohorts C")
    ap.add_argument("--local-steps", type=int, default=2,
                    help="pod: local SGD steps per cohort per round")
    ap.add_argument("--batch", type=int, default=2,
                    help="pod: sequences per local step")
    ap.add_argument("--seq", type=int, default=64,
                    help="pod: tokens per sequence")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def fl_config(args) -> FLConfig:
    """The run's FLConfig from the parsed command line; ``--scenario``
    is applied after the other flags, and an explicit ``--trace-path``
    wins over the scenario's own."""
    fl = FLConfig(num_clients=args.clients,
                  clients_per_round=(args.clients_per_round
                                     or max(2, args.clients // 4)),
                  local_epochs=2, local_batch_size=25, lr=args.lr,
                  algorithm=args.algorithm, env=args.env,
                  p_limited=args.p_limited,
                  p_delay=args.p_delay, max_delay=args.max_delay,
                  trace_path=args.trace_path, population=args.population,
                  server_plane=args.server_plane,
                  use_kernel=args.use_kernel,
                  client_reduce=args.client_reduce,
                  client_plane=args.client_plane,
                  prefetch_depth=args.prefetch_depth,
                  extended_metrics=bool(args.metrics_out),
                  comm_plane=args.comm_plane,
                  comm_topk_frac=args.comm_topk_frac,
                  cohorts=args.cohorts, local_steps=args.local_steps,
                  seed=args.seed)
    if args.scenario:
        fl = get_scenario(args.scenario).apply(fl)
        if args.trace_path:        # an explicit recording beats the
            fl = fl.with_(trace_path=args.trace_path)  # scenario default
    return fl


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    fl = fl_config(args)
    try:
        strategies.resolve(fl)
    except ValueError as e:
        ap.error(str(e))
    ours = not dist.is_initialized()     # engine_mesh may start a group
    try:
        if args.pod:
            return pod_scale(args, fl, device)
        return paper_scale(args, fl, device)
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
