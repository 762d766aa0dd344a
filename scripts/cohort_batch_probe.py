#!/usr/bin/env python3
"""Are a cohort's rows of the masked client plane independent of how many
cohorts share one vmapped call? The paper CNN's local training of C 10
cohorts against the same cohorts in blocks of 5, 2, 1 and 3 + 7, and the
ops under it (vmapped conv2d and matmul, forward and both gradients) at
batch 10 against 5 and 1. Prints each comparison; bitwise equality is
what a mesh of client width W needs for its ``off`` route to equal one
process (``launch/mesh.py``).

    python3 scripts/cohort_batch_probe.py            # on the card
    python3 scripts/cohort_batch_probe.py --device cpu --threads 1
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import grad, vmap

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.client import make_local_train
    from repro_torch.models.api import build_model
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import leaves
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    print(f"torch {torch.__version__}, device {dev}"
          + (f" ({torch.cuda.get_device_name(0)})" if dev.type == "cuda"
             else f", {torch.get_num_threads()} threads"))
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    model = build_model(get_arch("paper-cnn"))
    params = model.init(torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(0)
    C = 10
    batch = {"image": torch.as_tensor(
        rng.randn(C, 4, 10, 28, 28, 1).astype(np.float32), device=dev),
             "label": torch.as_tensor(
        rng.randint(0, 10, (C, 4, 10)).astype(np.int32), device=dev)}
    limited = torch.as_tensor(rng.rand(C) < 0.3, device=dev)
    for algo in ("ama_fes", "fedprox", "fedavg"):
        train = make_local_train(model, FLConfig(algorithm=algo, lr=0.1))
        full, full_loss = train(params, batch, limited)
        for parts in ((5, 5), (2,) * 5, (1,) * 10, (3, 7)):
            lo, same, worst = 0, True, 0.0
            for n in parts:
                sl = slice(lo, lo + n)
                p, loss = train(params, {k: v[sl] for k, v in batch.items()},
                                limited[sl])
                for x, y in zip(leaves(p), leaves(full)):
                    same = same and torch.equal(x, y[sl])
                    worst = max(worst, float((x - y[sl]).abs().max()))
                same = same and torch.equal(loss, full_loss[sl])
                lo += n
            print(f"{algo}: C {C} in blocks {parts}: bitwise {same}, max "
                  f"|diff| {worst:.3e}")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)
    conv = (lambda x, w: F.conv2d(x, w))
    mm = (lambda a, b: a @ b)
    for name, f, x, w in (
            ("conv2d 1->10 ch", conv, rand(C, 10, 1, 28, 28),
             rand(C, 10, 1, 5, 5)),
            ("conv2d 10->20 ch", conv, rand(C, 10, 10, 12, 12),
             rand(C, 20, 10, 5, 5)),
            ("matmul (10, 320) @ (320, 120)", mm, rand(C, 10, 320),
             rand(C, 320, 120))):
        ops = {"forward": vmap(f),
               "weight gradient": vmap(grad(
                   lambda w_, x_: f(x_, w_).square().sum())),
               "input gradient": vmap(grad(
                   lambda x_, w_: f(x_, w_).square().sum()))}
        for op, fn in ops.items():
            a, b = (w, x) if op == "weight gradient" else (x, w)
            ref = fn(a, b)
            for n in (5, 1):
                print(f"{name} {op}: batch {C} against {n}: bitwise "
                      f"{torch.equal(ref[:n], fn(a[:n], b[:n]))}")


if __name__ == "__main__":
    main()
