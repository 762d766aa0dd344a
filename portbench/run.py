"""The port's benchmark: one run of one cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It loads the cell named in
``BENCHMARK.json``, builds the port's pod path (``src/repro_torch``) on
the card, warms it up, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
object as the last line of standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.
The numbers compared end standard error, each beside its limit.

It exits with another code than 0, and prints no result, when there is
no CUDA device or fewer than the cell asks for, when the port cannot be
imported, and when JAX, jaxlib, flax or the JAX package (``repro``) is
loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # caches of the build tools stay in the checkout; nothing loads Flax;
    # the allocator maps memory into growing segments, so a round's large
    # stacks find room among the client plane's freed blocks
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from portbench import guard, spec
    cell = spec.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on "
             "a CUDA device only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    try:
        from portbench import harness
    except ImportError as e:
        fail(f"the port cannot be imported ({e}): run from a checkout of "
             "the repository")
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", T0)
    found = guard.forbidden_modules()
    if found:
        fail(f"forbidden modules loaded: {sorted(found)}", 3)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
