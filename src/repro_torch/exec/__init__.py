"""The chunked execution engine (``engine``) and its eval layer."""
from repro_torch.exec.engine import ChunkRunner, History, SimulationEngine
from repro_torch.exec.evals import Evaluator

__all__ = ["ChunkRunner", "History", "SimulationEngine", "Evaluator"]
