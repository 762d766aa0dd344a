"""Federated training launcher (paper scale) for the PyTorch/CUDA port.

K simulated clients over the synthetic non-iid shards, the paper's §V
experiment with its heterogeneity knobs, driven in ``--eval-every``
round chunks through the chunked engine; ``--no-scan`` runs the same
rounds one at a time (bit-identical). The run is on the GPU unless
``--device cpu`` asks for the CPU; on the GPU the server update of
every round is one hand-written CUDA kernel call (``--server-plane
ref`` runs the plain PyTorch version instead). ``--comm-plane`` compresses
the client uplink (bf16, q8, top-k with error feedback) and the server
consumes the compressed payload in-kernel; ``--env bandwidth`` prices the
(compressed) upload against a round deadline.

Examples:
  python -m repro_torch.launch.train --rounds 60 --p-limited 0.5 --eval-every 5
  python -m repro_torch.launch.train --algorithm fedavg --rounds 60
  python -m repro_torch.launch.train --algorithm fedopt --rounds 60
  python -m repro_torch.launch.train --comm-plane q8 --rounds 60
  python -m repro_torch.launch.train --p-delay 0.3 --max-delay 10 --rounds 30
  python -m repro_torch.launch.train --env bandwidth --max-delay 5 --comm-plane q8
  python -m repro_torch.launch.train --device cpu --rounds 2
"""
from __future__ import annotations

import argparse

from repro_torch import env as env_mod
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import strategies
from repro_torch.core.fes import count_trainable
from repro_torch.core.simulation import FederatedSimulation
from repro_torch.data.partition import shard_partition
from repro_torch.data.pipeline import build_clients
from repro_torch.data.synth import make_image_classification
from repro_torch.models.api import build_model
from repro_torch.utils.device import resolve_device


def paper_scale(args, fl: FLConfig, device):
    """Run the §V experiment; returns (simulation, History)."""
    model = build_model(get_arch(args.arch))
    train, test = make_image_classification(
        n_train=args.n_train, n_test=400, seed=fl.seed)
    clients = build_clients(
        train, shard_partition(train["label"], fl.num_clients, seed=fl.seed))
    sim = FederatedSimulation(model, fl, clients, test,
                              use_scan=not args.no_scan, device=device)
    n_clf, n_all = count_trainable(sim.params, model.fes_mask(sim.params))
    print(f"{args.arch} on {device}: {n_all} params ({n_clf} in the FES "
          f"classifier); {fl.algorithm} -> "
          f"{type(sim.strategy).__name__}, server plane {fl.server_plane}, "
          f"comm plane {fl.comm_plane}, env {fl.env}")
    hist = sim.run(rounds=args.rounds, eval_every=args.eval_every,
                   verbose=True)
    print(f"final: acc={hist.final_accuracy():.4f} "
          f"stability_var={hist.stability_variance():.3f}")
    return sim, hist


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="paper-cnn", choices=sorted(ARCHS))
    ap.add_argument("--algorithm", default="ama_fes",
                    choices=strategies.names())
    ap.add_argument("--env", default="bernoulli", choices=env_mod.names(),
                    help="environment (channel/device/participation model)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="cohort size m (0 = clients/4, the paper ratio)")
    ap.add_argument("--n-train", type=int, default=1500)
    ap.add_argument("--p-limited", type=float, default=0.25)
    ap.add_argument("--p-delay", type=float, default=0.0)
    ap.add_argument("--max-delay", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="eval cadence == chunk length")
    ap.add_argument("--server-plane", default="fused",
                    choices=("fused", "ref"),
                    help="server update: the CUDA kernel (default) or the "
                         "plain PyTorch version")
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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    fl = FLConfig(num_clients=args.clients,
                  clients_per_round=(args.clients_per_round
                                     or max(2, args.clients // 4)),
                  local_epochs=2, local_batch_size=25, lr=args.lr,
                  algorithm=args.algorithm, env=args.env,
                  p_limited=args.p_limited,
                  p_delay=args.p_delay, max_delay=args.max_delay,
                  server_plane=args.server_plane,
                  comm_plane=args.comm_plane,
                  comm_topk_frac=args.comm_topk_frac, seed=args.seed)
    return paper_scale(args, fl, device)


if __name__ == "__main__":
    main()
