"""round_ms.p90 (engine, ``exec/engine.py: ChunkRunner``): the 90th
percentile of the window's round times, each round one ``run_chunk``
call closed by a device sync, on the host clock."""
import statistics


def read(run):
    if len(run.round_s) < 2:
        return None
    return statistics.quantiles(run.round_s, n=10)[8] * 1e3
