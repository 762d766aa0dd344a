"""The ServerStrategy interface and the name-keyed strategy registry.

The paper's contribution is the server aggregation rule; everything else
(local SGD, the scheduler, the round loop) is shared machinery. A
``ServerStrategy`` packages the places an aggregation rule can differ:

  * ``init_state(params)`` — strategy-owned auxiliary server state (the
    async-AMA ring buffer, fedopt's Adam moments), carried through the
    round loop as a tree;
  * ``local_grad_transform`` / ``local_steps`` — client-side hooks (the
    FES gradient mask, FedProx's proximal pull and partial work);
  * ``limited_mode`` / ``static_local_steps`` — how a computing-limited
    cohort runs under the partitioned client plane (classifier-only
    differentiation, or a shorter step loop);
  * ``aggregate(t, prev_global, client_params, sched, aux)`` — the
    legacy per-leaf server chain (``core/ama.py``, ``core/async_ama.py``),
    whose mix runs on the ``ama_mix`` kernel when ``fl.use_kernel``;
  * ``fused_server_update(t, prev_global, client_params, sched, aux)``
    — the server update the round dispatches. ``fl.server_plane``
    selects "fused" (ONE fused server-plane kernel call per round per
    dtype group, ``repro_torch.kernels.server_plane``, on CUDA
    tensors), "ref" (its plain PyTorch version) or "legacy" (the
    ``aggregate`` chain);
  * ``compressed_server_update(t, prev_global, groups, sched, aux)`` —
    the same update over a comm plane's compressed payload, consumed
    in-kernel; ``NotImplemented`` (the default, and always under
    "legacy") makes the round densify the payload and call
    ``fused_server_update``;
  * ``reduced_server_update(t, prev_global, client_params, sched, aux)``
    — the update with the client axis pre-reduced by one weighted
    contraction (``fl.client_reduce == "force"``);
  * ``mix_coefficient(t, sched, aux)`` — the effective previous-model
    mix coefficient, the telemetry's ``alpha_eff``.

Implementations are functional and never read device values on the
host: the round runs without a host sync.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.kernels.ref import _norm_weights
from repro_torch.utils.reduce import reduce_leading
from repro_torch.utils.tree import tree_map

SERVER_PLANES = ("fused", "ref", "legacy")


class ServerStrategy:
    """Base class: stateless, no grad transform, every step active."""

    #: registry key; aliases are extra names resolving to the same class
    name: str = ""
    aliases: tuple[str, ...] = ()

    def __init__(self, fl: FLConfig):
        if fl.server_plane == "interpret":
            raise ValueError(
                "server_plane='interpret' runs the JAX package's Pallas "
                "kernels through the Pallas interpreter, which has no "
                f"counterpart in the port; use one of {SERVER_PLANES}")
        if fl.server_plane not in SERVER_PLANES:
            raise ValueError(f"unknown server_plane {fl.server_plane!r}; "
                             f"the port has {SERVER_PLANES}")
        self.fl = fl

    # ---------------------------------------------------- server side ----
    def init_state(self, params):
        """Strategy-owned auxiliary server state (a tree; {} if none)."""
        del params
        return {}

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        """One server update through the legacy per-leaf chain. ``t`` is
        the round index (a 0-dim int32 device tensor); ``client_params``
        has a leading client axis; ``sched`` is {"limited", "delayed",
        "delays", "data_sizes"}, each (C,) on the device. Returns
        (new_global, new_aux_state)."""
        raise NotImplementedError

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        """The server update the round dispatches; same contract as
        ``aggregate``. This fallback routes to ``aggregate``; the
        built-in strategies override it with the fused kernels and route
        to ``aggregate`` only under ``server_plane == "legacy"``."""
        return self.aggregate(t, prev_global, client_params, sched,
                              aux_state)

    def compressed_server_update(self, t, prev_global, groups, sched,
                                 aux_state):
        """The server update consuming a comm plane's compressed payload
        directly (``groups``: ``repro_torch.comm``'s ``[(leaf_idxs,
        payload)]`` list, see ``server_mix_compressed_tree``). The mix
        family overrides this; strategies whose update is not linear in
        the client deltas (the async ring buffer, server-Adam) keep this
        default, and the round densifies the payload
        (``CommPlane.reconstruct``) before their fused update."""
        del t, prev_global, groups, sched, aux_state
        return NotImplemented

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        """The server update with the stacked client axis pre-reduced:
        every built-in rule consumes ``client_params`` only through
        weighted sums over the client axis, so one contraction
        (``utils.reduce.reduce_leading``) comes first and the server
        math runs on (N,) sums. allclose to the fused plane, not bitwise
        (another summation order). ``NotImplemented`` (this default)
        keeps the fused plane."""
        del t, prev_global, client_params, sched, aux_state
        return NotImplemented

    @property
    def server_impl(self) -> str:
        return self.fl.server_plane

    # ---------------------------------------------------- telemetry ----
    def mix_coefficient(self, t, sched, aux_state):
        """The effective previous-model mix coefficient alpha of this
        round's update (the telemetry's ``alpha_eff``), a 0-dim f32 on
        ``t``'s device; 0 for pure weighted-average rules."""
        del sched, aux_state
        return torch.zeros((), dtype=torch.float32,
                           device=torch.as_tensor(t).device)

    # ---------------------------------------------------- client side ----
    def local_grad_transform(self, grads, params, global_params, fes_mask,
                             limited):
        """Per-step gradient hook over stacked (C, ...) grads."""
        del params, global_params, fes_mask, limited
        return grads

    def local_steps(self, n_steps: int, limited):
        """(C,) int32 active local steps per client."""
        return torch.full(limited.shape, n_steps, dtype=torch.int32,
                          device=limited.device)

    # -------------------------------------- partitioned client plane ----
    @property
    def limited_mode(self) -> str:
        """How a computing-limited cohort runs under the partitioned
        client plane (``fl.client_plane == "partitioned"``): "full" takes
        the gradients an unlimited cohort takes (this default: no FES
        mask, so the masked plane trains limited cohorts fully too);
        "classifier" differentiates the classifier only, so the body's
        backward is never built (AMA-FES, paper Eq. 3)."""
        return "full"

    def static_local_steps(self, n_steps: int) -> int:
        """Python-int local-step budget of a limited cohort: the length
        of the partitioned plane's limited step loop. Must agree with
        ``local_steps(n_steps, limited=True)`` for the two planes to
        train the same model."""
        return n_steps


def reduced_mix_update(prev_global, client_params, sched, keep, alpha):
    """The mix-family server plane (``kernels.ref.server_mix_math``) with
    the client axis pre-reduced: out = a_eff * prev + sum_k (beta * w_k)
    * x_k, the sum ONE ``reduce_leading`` contraction. Shared by ama,
    fedavg and fedprox, which differ only in ``keep`` and alpha."""
    beta = 1.0 - alpha
    w, tot = _norm_weights(sched["data_sizes"], keep)
    a_eff = torch.where(tot > 0, alpha, alpha + beta)
    red = reduce_leading(client_params, beta * w)
    return tree_map(lambda p, r: (p.float() * a_eff + r).to(p.dtype),
                    prev_global, red)


_REGISTRY: dict[str, type[ServerStrategy]] = {}


def register(cls: type[ServerStrategy]) -> type[ServerStrategy]:
    """Class decorator: file-local registration under name + aliases."""
    assert cls.name, cls
    for key in (cls.name,) + tuple(cls.aliases):
        assert key not in _REGISTRY or _REGISTRY[key] is cls, key
        _REGISTRY[key] = cls
    return cls


def names() -> list[str]:
    """All registered strategy names (aliases included), sorted."""
    return sorted(_REGISTRY)


def get(name: str) -> type[ServerStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {names()}") from None


def resolve(fl: FLConfig) -> ServerStrategy:
    """Instantiate the strategy for a config. The AMA family upgrades to
    the asynchronous variant when the environment has delays
    (``max_delay > 0``), as in the JAX package."""
    cls = get(fl.algorithm)
    if fl.max_delay > 0 and cls.name == "ama":
        cls = get("async_ama")
    return cls(fl)
