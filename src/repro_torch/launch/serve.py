"""Serving launcher: a thin front over the serving engines (the port of
the JAX package's ``launch/serve.py``). Runs on the GPU unless
``--device cpu`` is given; without a CUDA device it refuses.

  python -m repro_torch.launch.serve --arch minitron-8b --reduced \
      --device cpu --tokens 16
  python -m repro_torch.launch.serve --arch minitron-8b --reduced \
      --device cpu --engine paged --prompt-mix 6x2,20x2 \
      --max-batch-tokens 256 --metrics-out serve.jsonl
  python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced \
      --device cpu            # the loop engine only (recurrent state)
  python -m repro_torch.launch.serve --arch whisper-medium --reduced \
      --device cpu --prefill-chunk 8   # the loop engine only, as in JAX
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --reduced \
      --device cpu --engine paged      # tokens only, as the dense family

whisper-medium's batch is encoded once from zero frame embeddings (the
frontend is a stub) and served with ``lm_head`` padded to 51,872
columns (``encdec.serve_params``, applied by the engine once).

Engines (``repro_torch.serve``):
  loop   lockstep per-token decode with per-request prompt lengths
         (padded positions never enter the KV cache); with
         --prefill-chunk > 0 the shared prompt prefix is prefilled in
         chunks, bit-identically to the per-token path.
  paged  continuous batching over a shared paged KV pool: FIFO
         token-budget admission (--max-batch-tokens), per-request block
         tables, chunked prefill straight into the pool.

Workload: a uniform batch (--batch x --prompt-len), a mixture
(--prompt-mix "LENxCOUNT,..."), or a request trace (--trace, JSONL rows
{"id": int, "prompt_len": int | "prompt": [ids], "max_new": int}).

--metrics-out writes serving telemetry (one "serve" row per request:
queue/prefill/decode seconds; one "serve_summary" row: tokens/s and
p50/p95/p99) through ``obs.log.MetricsLogger``. --checkpoint serves a
params file or a trainer's {params, t, aux} round state (either
package's). ``serve(args, cfg, device)`` runs one workload for a given
config (a depth-cut full-width one, say) and returns the results.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.checkpoint.io import restore_params
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import serving_config
from repro_torch.models.api import build_model
from repro_torch.obs.timing import profile_trace, sync_time
from repro_torch.serve import LoopEngine, PagedEngine, Request
from repro_torch.utils.device import resolve_device


def batched_decode(model, params, prompts, max_new: int, max_len: int,
                   lengths=None):
    """prompts: (B, P) int32. Greedy decode max_new tokens.

    ``lengths`` (optional, (B,) ints) gives each row's REAL prompt
    length; rows are right-padded to P but padded positions never enter
    the KV cache: each row decodes from its own length. Without it every
    row is taken at full length P. Returns (B, P + max_new) int32 on
    the CPU.
    """
    assert prompts.ndim == 2 and prompts.shape[1] >= 1, \
        f"prompts must be (B, P>=1) int32, got {tuple(prompts.shape)}"
    B, P = prompts.shape
    lens = [int(x) for x in (lengths if lengths is not None else [P] * B)]
    host = np.asarray(prompts)
    reqs = [Request(rid=b, prompt=host[b, :lens[b]].tolist(),
                    max_new=max_new) for b in range(B)]
    results = LoopEngine(model, params).run(reqs)
    gen = np.zeros((B, max_new), np.int32)
    for b, r in enumerate(results):
        gen[b] = r["tokens"][lens[b]:lens[b] + max_new]
    return torch.from_numpy(np.concatenate([host.astype(np.int32), gen], 1))


def _mixture_requests(spec: str, max_new: int, vocab: int, seed: int = 0):
    """'8x4,24x2' -> 4 prompts of len 8 + 2 of len 24 (random tokens)."""
    rng = np.random.RandomState(seed)
    reqs, rid = [], 0
    for part in spec.split(","):
        ln, cnt = (int(v) for v in part.strip().split("x"))
        for _ in range(cnt):
            reqs.append(Request(
                rid=rid, max_new=max_new,
                prompt=rng.randint(1, vocab, (ln,)).tolist()))
            rid += 1
    return reqs


def _trace_requests(path: str, max_new: int, vocab: int):
    rng = np.random.RandomState(0)
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            prompt = row.get("prompt")
            if prompt is None:
                prompt = rng.randint(
                    1, vocab, (int(row["prompt_len"]),)).tolist()
            reqs.append(Request(rid=int(row.get("id", i)), prompt=prompt,
                                max_new=int(row.get("max_new", max_new))))
    return reqs


def build_engine(model, params, args):
    if args.engine == "paged":
        return PagedEngine(model, params, max_slots=args.max_slots,
                           block_size=args.block_size,
                           max_batch_tokens=args.max_batch_tokens,
                           prefill_chunk=args.prefill_chunk)
    return LoopEngine(model, params, prefill_chunk=args.prefill_chunk)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("loop", "paged"), default="loop")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prompt-mix", default=None, metavar="LxN,...",
                    help='mixed prompt lengths, e.g. "8x4,24x2"')
    ap.add_argument("--trace", default=None, metavar="JSONL",
                    help="request trace: rows with id/prompt_len|prompt/"
                         "max_new")
    ap.add_argument("--tokens", type=int, default=16,
                    help="max_new per request (trace rows may override)")
    ap.add_argument("--max-batch-tokens", type=int, default=0,
                    help="paged: in-flight sum(prompt+max_new) budget "
                         "(0 = unbounded)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="chunked-prefill width (loop: 0 = per-token)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--metrics-out", default=None, metavar="JSONL")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run under torch.profiler and write the Chrome "
                         "trace to DIR/trace.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def requests_of(args, vocab: int) -> list[Request]:
    if args.trace:
        return _trace_requests(args.trace, args.tokens, vocab)
    if args.prompt_mix:
        return _mixture_requests(args.prompt_mix, args.tokens, vocab)
    return _mixture_requests(f"{args.prompt_len}x{args.batch}", args.tokens,
                             vocab)


def serve(args, cfg, device, params=None):
    """Serve ``args``' workload with ``cfg`` on ``device``. ``params``
    default to the model's init from seed 0, drawn on ``device`` (or
    ``--checkpoint``'s). Returns (results, summary, seconds closed by a
    device sync, the engine)."""
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init(gen, device)
    if args.checkpoint:
        params = restore_params(args.checkpoint, params)
        print(f"restored {args.checkpoint}")
    reqs = requests_of(args, cfg.vocab_size)
    engine = build_engine(model, params, args)
    with profile_trace(args.profile):
        dt, results = sync_time(engine.run, reqs)
    summary = engine.last_summary
    if args.metrics_out:
        from repro_torch.obs.log import MetricsLogger
        with MetricsLogger(args.metrics_out) as log:
            log.header(extra={"serve": {
                "arch": cfg.name, "engine": args.engine,
                "requests": len(reqs), "device": str(device),
                "max_batch_tokens": args.max_batch_tokens,
                "max_slots": args.max_slots,
                "block_size": args.block_size,
                "prefill_chunk": args.prefill_chunk}})
            for r in results:
                log.serve(r)
            log.serve_summary(summary)
        print(f"wrote {args.metrics_out}")
    return results, summary, dt, engine


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = serving_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    results, summary, dt, _ = serve(args, cfg, device)
    print(f"engine={args.engine} served {summary['requests']} requests, "
          f"{summary['new_tokens']} new tokens in {dt:.2f}s "
          f"({summary['tokens_per_s']} tok/s, p50 {summary['p50_ms']}ms "
          f"p95 {summary['p95_ms']}ms p99 {summary['p99_ms']}ms) on "
          f"{device}")
    print("sample:", results[0]["tokens"][:24])
    return results


if __name__ == "__main__":
    main()
