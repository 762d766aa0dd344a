"""Paper-scale federated simulation (K clients, m selected/round).

``FederatedSimulation`` is the paper's §V experiment on the chunked
execution engine (``repro_torch.exec.engine``), fed from K simulated
clients' non-iid shards with the heterogeneous environment of §V.
"""
from __future__ import annotations

from repro_torch.exec.engine import History, SimulationEngine

__all__ = ["FederatedSimulation", "History"]


class FederatedSimulation(SimulationEngine):
    """The paper's §V experiment: ``run`` goes through the chunked
    engine (``use_scan=False`` for the bit-identical per-round run);
    ``save``/``resume`` checkpoint the full round state, ``run_round``
    runs one round. ``mesh=launch.mesh.engine_mesh(m)`` splits each
    round's m cohorts over the ranks of a ``torchrun`` launch, as the
    JAX package's ``FederatedSimulation(..., mesh=)`` shards them over
    its devices."""
