"""The federated round and the multi-round train loop.

``make_round_step`` is the paper's Algorithm 1 as one function: the C
selected clients train in parallel, then ONE fused server-plane kernel
launch per dtype group (``strategy.fused_server_update``) makes the new
global model. The client plane is the masked one (``fl.client_plane ==
"masked"``: one program, limited cohorts' body gradients zeroed), the
partitioned one ("partitioned": limited cohorts gathered into a
classifier-only or shorter program by the ``PARTITION_KEYS`` arrays of
the schedule, the paper's Eq. 3 computation reduction) or, with
``fl.fes_static``, the classifier-only program for every cohort.
``make_train_loop`` runs a chunk of rounds as a Python loop over the
stacked per-round schedules and batches, or one batch fed to every
round (the JAX package's ``lax.scan``). Nothing inside a round reads a
device value on the host; the round index itself lives on the device.

With a comm plane (``fl.comm_plane != "none"``, ``repro_torch.comm``)
the stacked client deltas are compressed before the server update, the
error-feedback residual rides the carry as ``aux["comm"]``, and the
server consumes the payload in-kernel (``compressed_server_update``) or,
for strategies without that hook, densified.

Under a mesh (``launch.mesh.FLMesh``, made active by ``ChunkRunner``)
the client axis is split over the ranks, as the JAX package splits it
over the mesh's "client" axis: a rank trains its own cohort block
(``sharding.ctx.constrain_leading`` of the schedule; the batch arrives
as that block), then either all-gathers the blocks into the (C, ...)
stack before the fused server plane (``gather_leading``; the same bits
as one process given the same rows) or pre-reduces them
(``fl.client_reduce``: "force" always, "auto" when the client width is
above 1, as in the JAX package; ``reduced_server_update``: each rank's
weighted partial, summed across ranks in rank order by
``sharding.ctx.reduce_leading``, then the server math on (N,) sums).
Without a mesh, or at client width 1, "auto" stays off. The per-cohort
losses are gathered in cohort order before their mean. Every rank runs
the same server update on the same inputs and keeps the same state.
With a comm plane a rank compresses its own rows against its own block
of the error-feedback residual (``init_state(..., mesh=)``), then
either gathers the compressed payload (``CommPlane.gather``: the bytes
on the wire are the compressed ones) for the server kernel that
consumes it, or, pre-reduced, reconstructs its rows and sums f32
partials as without a plane (the partials travel, not the payloads).
The partitioned plane takes the rank's own plan, built over its block
(``exec.engine.ChunkRunner``); ``fes_static`` needs nothing more.
``fl.extended_metrics`` adds the telemetry
series of ``repro_torch.obs.metrics.round_metrics`` to each round's
metrics. They only read the round's tensors (eager PyTorch has no
cross-op fusion to perturb), so the params stream is bitwise the same
with them on or off.

All algorithm behaviour comes from the ServerStrategy registry
(``repro_torch.core.strategies``).
"""
from __future__ import annotations

import torch

from repro_torch import comm
from repro_torch.configs.base import FLConfig
from repro_torch.core import strategies
from repro_torch.core.client import (make_fes_local_train, make_local_train,
                                     make_partitioned_local_train)
from repro_torch.obs.metrics import payload_bytes, round_metrics
from repro_torch.sharding import ctx

CLIENT_REDUCE = ("auto", "off", "force")

#: the partitioned client plane's dispatch arrays
#: (``data.pipeline.partition_plan``), carried by the schedule dict when
#: ``fl.client_plane == "partitioned"``
PARTITION_KEYS = ("part_full_idx", "part_lim_idx", "part_src_row",
                  "part_from_lim")


def check_supported(fl: FLConfig) -> None:
    """Refuse config values the port has no code path for, rather than
    ignoring them."""
    if fl.client_reduce not in CLIENT_REDUCE:
        raise ValueError(f"unknown client_reduce {fl.client_reduce!r}; "
                         f"expected one of {CLIENT_REDUCE}")


def as_scan_scheds(sb: dict, device) -> dict:
    """Device tensors of the schedule leaves the round consumes, from a
    stacked ``Environment.batch`` dict (``selected`` stays on the host:
    it addresses client datasets, not cohort slots). The partition-plan
    arrays, when staged, pass through."""
    out = {"limited": torch.as_tensor(sb["limited"], device=device),
           "delayed": torch.as_tensor(sb["delayed"], device=device),
           "delays": torch.as_tensor(sb["delays"], dtype=torch.int32,
                                     device=device),
           "data_sizes": torch.as_tensor(sb["data_sizes"],
                                         dtype=torch.float32, device=device)}
    for k in PARTITION_KEYS:
        if k in sb:
            out[k] = torch.as_tensor(sb[k], device=device)
    return out


def init_state(model, fl: FLConfig, gen: torch.Generator, device,
               strategy=None, mesh=None):
    """Round-loop carry: global params, round index (a 0-dim int32 device
    tensor) and the strategy's aux state. With a comm plane the
    error-feedback residual rides the aux under ``"comm"``: one (C, N_g)
    f32 tensor per dtype group, C = ``fl.clients_per_round``; under a
    ``mesh`` of client width > 1, the rank's (C / client, N_g) block."""
    strategy = strategy or strategies.resolve(fl)
    params = model.init(gen, device)
    aux = strategy.init_state(params)
    plane = comm.resolve(fl)
    if plane is not None:
        C = fl.clients_per_round
        rows = (C // mesh.client if mesh is not None and mesh.client > 1
                else C)
        res = plane.init_residual(params, rows)
        if res:
            aux = {**aux, "comm": res}
    return {"params": params,
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "aux": aux}


def make_round_step(model, fl: FLConfig, strategy=None):
    """Returns round_step(state, batch, sched) -> (state, metrics).

    batch: {field: (C, steps, b, ...)}; sched: {"limited", "delayed",
    "delays", "data_sizes"}, each (C,); under the partitioned client
    plane also the ``PARTITION_KEYS`` arrays (``ChunkRunner`` merges
    them in when it stages a chunk).
    """
    check_supported(fl)
    strategy = strategy or strategies.resolve(fl)
    if fl.fes_static:
        plane = make_fes_local_train(model, fl)
        local_train = lambda g, b, sched: plane(g, b, sched["limited"])
    elif fl.client_plane == "partitioned":
        plane = make_partitioned_local_train(model, fl, strategy)

        def local_train(g, b, sched):
            if "part_src_row" not in sched:
                raise KeyError(
                    "client_plane='partitioned' needs the partition-plan "
                    "arrays in sched: stage through ChunkRunner or merge "
                    "data.pipeline.partition_plan(limited) yourself")
            if sched["part_src_row"].shape != sched["limited"].shape:
                raise ValueError(
                    f"the partition plan addresses "
                    f"{sched['part_src_row'].shape[0]} cohort slots and "
                    f"this rank trains {sched['limited'].shape[0]}: under "
                    "a split client axis build it over the rank's block, "
                    "partition_plan(limited[:, block])")
            return plane(g, b, sched)
    elif fl.client_plane == "masked":
        plane = make_local_train(model, fl, strategy)
        local_train = lambda g, b, sched: plane(g, b, sched["limited"])
    else:
        raise ValueError(f"unknown client_plane {fl.client_plane!r}; "
                         "expected 'masked' or 'partitioned'")
    comm_plane = comm.resolve(fl)

    extended = fl.extended_metrics

    def round_step(state, batch, sched):
        t, prev_global = state["t"], state["params"]
        C = sched["limited"].shape[0]
        # the rank's block of the schedule; the partition plan is the
        # rank's own already and never goes through the slicing by shape
        plan = {k: sched[k] for k in PARTITION_KEYS if k in sched}
        mine = {**ctx.constrain_leading(
            {k: v for k, v in sched.items() if k not in plan}, C), **plan}
        client_params, losses = local_train(prev_global, batch, mine)
        # client_params: the rank's block while ``local``
        local = ctx.axis_size("client") > 1
        reduce = ctx.pre_reduced(fl, ctx.active_mesh())
        srv_aux, new_res, out = state["aux"], None, NotImplemented
        groups = None
        if comm_plane is not None:
            # the residual is comm state, not strategy state: popped
            # here, so the strategy never sees it. The rank compresses
            # its own rows; only the payload travels.
            srv_aux = {k: v for k, v in state["aux"].items() if k != "comm"}
            groups, new_res = comm_plane.compress(
                t, prev_global, client_params, state["aux"].get("comm", {}),
                row0=ctx.block(C).start)
        elif not reduce:
            client_params = ctx.gather_leading(client_params)
            local = False
        if reduce:
            cp = (comm_plane.reconstruct(prev_global, groups)
                  if comm_plane is not None else client_params)
            out = strategy.reduced_server_update(t, prev_global, cp, sched,
                                                 srv_aux)
            if out is NotImplemented and local and comm_plane is None:
                client_params = ctx.gather_leading(client_params)
                local = False
        if out is NotImplemented and comm_plane is not None:
            groups = comm_plane.gather(groups)
            out = strategy.compressed_server_update(t, prev_global, groups,
                                                    sched, srv_aux)
            if out is NotImplemented:
                client_params = comm_plane.reconstruct(prev_global, groups)
                local = False
        if out is NotImplemented:
            out = strategy.fused_server_update(t, prev_global, client_params,
                                               sched, srv_aux)
        new_params, aux = out
        if new_res:
            aux = {**aux, "comm": new_res}
        metrics = {"loss": ctx.gather_leading(losses).mean(),
                   "n_on_time": (~sched["delayed"]).sum(dtype=torch.int32)}
        if extended:
            metrics.update(round_metrics(
                fl, strategy, t, prev_global, client_params, new_params,
                sched, state["aux"], payload=payload_bytes(prev_global),
                payload_compressed=(comm_plane.payload_bytes(prev_global)
                                    if comm_plane is not None else None),
                shard_sum=ctx.sum_shards if local else None))
        return {"params": new_params, "t": t + 1, "aux": aux}, metrics

    return round_step


def make_train_loop(model, fl: FLConfig, strategy=None, *,
                    per_round_batch: bool = False):
    """Returns train_loop(state, batch, scheds) -> (state, metrics):
    ``scheds`` leaves carry a leading (n_rounds,) axis; metrics come back
    stacked per round as device tensors. With ``per_round_batch`` the
    batch leaves carry a leading (n_rounds,) axis too (a fresh batch
    every round, the paper-scale engine); without it the same (C, steps,
    b, ...) batch is fed to every round (the pod path's throughput
    configuration, as in the JAX package)."""
    round_step = make_round_step(model, fl, strategy)

    def train_loop(state, batch, scheds):
        rows = []
        for r in range(scheds["limited"].shape[0]):
            b = ({k: v[r] for k, v in batch.items()} if per_round_batch
                 else batch)
            state, m = round_step(state, b,
                                  {k: v[r] for k, v in scheds.items()})
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return train_loop
