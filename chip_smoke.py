#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # from the repository root

Phases (any error or out-of-tolerance result exits non-zero):
  1. header: torch / CUDA versions and the card's name and power limit;
  2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, started together); ptxas's registers, spills
     and static shared memory of every kernel;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes, larger ones and edge cases (nobody kept, K = 1,
     ragged tails, top-k positions colliding across clients, K-fold and
     at K = 256, with server_mix_scatter's one device kernel a call
     counted in a profiler trace; server_mix, server_async, server_adam
     and server_mix_delta bitwise in every case (server_async in every
     round of three wraps of its ring), each naming the kernel it took
     (16-byte vectors where N is a multiple of the vector and the
     operands are aligned, for server_async also K <= 8; one element a
     thread otherwise, a base pointer offset by one element among them;
     server_adam and server_mix_delta also at N = 33,554,432 and
     33,554,437), server_mix also at the
     LLM paths' N = 2,583,711,744 and 1,018,698,240 bf16, K = 2;
     ama_mix one leaf a call and many (the CNN's 8 leaves in one launch,
     100 leaves in two, two dtype pairs in two, an unaligned leaf), its
     launches counted;
     the flash-attention forward and both backward passes at the LLM
     path's (B 2, S 2048, H 32, hd 128) bf16 causal, kv head-repeated
     and at its 8 kv heads (GQA), and at hd 64 / 96, f32, a window,
     non-causal, one tile, B*H = 1, GQA at n_rep 2 and ragged S = 100,
     under FlashAttention's error rule, each dtype on its own design
     (bf16 on the tensor cores, f32 on the CUDA cores); the rwkv6
     recurrence forward and
     backward at the rwkv6 path's (B 2, S 2048, H 40, hd 64) f32 and at
     B*H = 1, S 64 / 96, hd 16 / 32, ragged segments (S 100, S 2047),
     one segment (S 16), the serving path's decode step (S 1) and decays
     near 0 and 1, within 1e-5 x (1 + max |plain|), each call two device
     kernels (its two passes)); serve_attention at minitron-8b's serving
     shape (32 heads over 8 kv heads of 128, a ring of 4096): decode and
     prefill chunks of 8 and 64, a window of 4096 over a wrapped ring and
     a linear cache (its last block the null block when paged), pad rows,
     B 1 and 4, bf16 and f32, under FlashAttention's rule, the paged pool
     bitwise the dense cache, chunk rows bitwise the row at c = 1 (SDPA
     the dense decode's yardstick); invariant_dense at every minitron-8b
     serving projection in bf16 (rows bitwise at M 1, 4, 5, 64, 256 and
     260; within twice cuBLAS's error against the f32 product, floor one
     bf16 ulp) and at a reduced f32 shape, with its times at M 4 and 256
     (weights cold) beside torch.matmul; invariant_rmsnorm's two forms
     (the residual add and the norm in one launch, and the norm alone) at
     d 4096 and 16384 bf16, d 256 f32 and d 1000 bf16 (per element): rows
     bitwise, s bitwise x + h, y bitwise the norm alone on s, within
     N_ULP of the plain version; the add then the norm against the fused
     call, device and host time; with
     device times (CUDA-graph replay) beside the least time the card
     could take (its bound; for rwkv6 also its design's bound), the
     plain version's and a library call's;
  4. the main paths: ``repro_torch.launch.train`` in this process at the
     paper CNN's full width: ama_fes, fedavg, async_ama (slice 1);
     fedprox, fedopt; the comm planes q8, bf16 and topk; fedopt and
     async_ama over a densified q8 payload; fedavg in the bandwidth
     environment, dense and q8 (with the on-time share of each); the
     legacy chain on the ama_mix kernel (``--server-plane legacy
     --use-kernel``: ama_fes, fedavg, fedprox, fedopt, async_ama; slice
     3). Each run asserts the exact launches of every kernel (rounds x
     dtype groups; ama_mix's 8 leaves are one group; server_async,
     server_adam and server_mix_delta all on their 16-byte kernels) and
     that no plain version ran on the card. The
     LLM paths: ``--pod`` federated training at full width, with the
     configs' own remat on (each block keeps only its input and runs
     forward again in the backward), of minitron-8b (2 of its 32 layers,
     2,583,711,744 bf16 parameters; slice 4) and of rwkv6-3b (8 of its 32
     layers, 1,018,698,240 bf16 parameters; slice 5), 2 cohorts x 2 local
     steps x 1 x 2048 tokens, 3 rounds, ama_fes and fedavg each, with the
     exact launches of the path's kernels (flash attention, all on the
     tensor cores, or the rwkv6 recurrence; the forward kernels twice a
     layer a step under remat) and of server_mix, falling losses,
     rounds/s, tokens/s and the peak device memory (under 75 GB); ama_fes
     again with remat off, bitwise equal to the remat run, with both
     peaks; then rwkv6-3b for one round at the deepest depth (up to all
     32 layers) whose peak a probe run at 16 layers predicts within 70 GB.
     The client planes (slice 11): ``--client-plane partitioned`` runs of
     ama_fes, fedprox, async_ama and fedopt on the CNN (server-kernel
     launches exact, the limited cohort-rounds on the limited program
     and those overflowed to the masked one, rounds/s beside the masked
     run), an ``FLConfig(fes_static=True)`` ama_fes run (body leaves
     within the mix's rounding of their start, the classifier moved);
     on each LLM path (--no-scan) a partitioned ama_fes run at
     p_limited 0.5 and masked against partitioned at p_limited 1.0, the
     kernels' launches derived from the staged schedule (a limited
     cohort's body blocks run their forward kernels once and no
     backward), falling losses, tokens/s and peak memory.
     The host plane's worlds (slice 12): async_ama for 30 rounds under
     each named scenario (clear, moderate-30, severe-70, bursty,
     bursty-severe, bandwidth-limited, mobility-trace) and ama_fes under
     bursty-severe, through --scenario: server_async's launches exact,
     every one on its 16-byte kernel (bursty-severe's ring of Q = 16
     among them), the delayed share, mean and largest delay, final
     accuracy and stability variance; bursty-severe and mobility-trace
     fused == --server-plane ref and bursty-severe chunked == per round,
     bitwise. The federation scale: FederatedSimulation over
     VirtualClientShards at K 1,000 (dense schedule) and 1,000,000
     (virtual) x C 5, 32, 128 as the JAX package's
     benchmarks/federation_scale.py defines a cell, and async_ama at
     K 1,000,000, C 32: rounds/s (best and spread of 3 runs), the
     engine's schedule + staging ms a round, the K ratio per C,
     server_async's kernel per C (16-byte at C 5, per element above);
     K 1,000 virtual over the shards == over a dense client list of
     them, bitwise;
     Serving (slices 13-14): a row-invariance probe at minitron's full
     width (bf16, M = 4 against M = 256: the serving path's
     invariant_dense, both forms of invariant_rmsnorm and argmax, each a
     check, and torch.matmul and layers.rmsnorm as a yardstick);
     minitron-8b CONFIG_SWA (window 4096) at its published widths and all
     32 layers through
     ``launch.serve.serve``: PagedEngine (4 slots, blocks of 16, prefill
     chunk 64) over two prompts of 4,000 tokens (the ring wraps), four of
     512 and four of 128, 128 new tokens each; LoopEngine per token,
     chunked 64 and PagedEngine over 4 requests of 64-300 tokens; rwkv6-3b
     at 8 layers per token (the paged engine refused): tokens/s,
     p50/p95/p99, prefill and decode seconds, peak memory (under 75 GB),
     the decode step's weight bound, exact launches of serve_attention
     (layers x serving steps), invariant_dense ((4 layers + 1) x steps),
     invariant_add_rmsnorm (2 layers x steps), invariant_rmsnorm (1 x
     steps) and rwkv6_fwd (layers x decode steps), no plain version on
     the card, loop chunked 64 and paged serving the per-token loop's
     tokens at full width; a profile of the paged engine (2 prefill
     chunks, 16 decode steps) and the device kernels of one traced
     32-layer decode step; then at
     reduced size paged == dense bitwise, reduced f32 card == CPU,
     chunked == per token bitwise and the engines' tokens equal;
  5. fused against plain server planes on the card (ama_fes, async_ama,
     fedopt, ama_fes + q8, ama_fes + topk, 10 rounds each); the legacy
     chain with --use-kernel against it without (ama_fes, async_ama,
     fedopt, 10 rounds each); the reduced LLM paths (minitron-8b,
     rwkv6-3b, remat on) in f32 on the card (kernels) against the CPU
     (plain versions), on the masked and the partitioned client plane;
     one round of the CNN's client planes, partitioned against masked per
     cohort (whether the unlimited cohorts come out bitwise reported);
  6. the port's contract: chunked == per-round, bitwise (async_ama,
     fedopt, ama_fes + q8, async_ama partitioned, both reduced LLM
     paths and reduced minitron-8b partitioned); chunked ==
     per-round == save -> restore -> continue over 20 rounds (ama_fes,
     async_ama, fedopt); prefetch depths 0, 1, 2 bitwise equal;
     --metrics-out on == off bitwise, and its JSONL valid;
  7. torch.profiler breakdowns of 10 ama_fes rounds and of 2 full-width
     rounds of each LLM under remat (through the launcher's --profile),
     with each of the LLM's kernel wrappers' device time and share, split
     into its kernels (the rwkv6 passes), and of 2 minitron-8b rounds
     with every cohort limited on the partitioned plane; a line counting
     the profiler sessions that traced no device activity.
Slice 17 (the moe family and the large dense configs) adds, in the
phases above: phase 3 at their shapes (flash at mixtral's 48 heads over
8 with its window of 4096; serve_attention decode and c 64 at n_rep 6,
12 and 16; invariant_dense at llama3-405b's w_in, qwen1.5-110b's biased
wq|wk|wv and its lm_head, the experts' pairs and w_out, and the f32
routers at N 16 and 8, ``check_dense_wide``; invariant_rmsnorm at d
6144, 8192 and 12288); in phase 4 phi3.5-moe's pod path at full width (2
of 32 layers, ``moe_pod_path``: server_mix 2 a round, one launch for each
dtype group), the MoE serving ops in the row-invariance probe, and the
five configs served at their published widths, depth cut to 31-35 GB of
weights (``serving_families``: the moe pair's loop chunked 64 and paged
serving the per-token loop's tokens); in phases 5-6 the reduced
phi3.5-moe (global and blocked dispatch, masked and partitioned),
mixtral (window 16) and qwen (qkv bias) paths, card == CPU and chunked
== per round (``moe_reduced_on_card``); in phase 7 a profile of 2
phi3.5-moe rounds with the device time of its MoE layers' dispatch,
experts' GEMMs and combine read from the trace's profiler ranges
(``moe_where_time_goes``). The full-width pod runs of phases 4-7 share
one parameter draw a config (``MemoInit``).
Slice 18 (the hybrid family, zamba2-1.2b) adds: in phase 3 the mamba2
recurrence's forward and backward kernels against their plain versions
(``check_mamba2``: the pod shape (B 2, S 2048, H 64, P 64, N 64), the
reduced widths (H 8, N 16), S 100, S 1, h0 = 0, decays near 0 and near
1; within 1e-5 x (1 + max |plain|); times, plain times and bounds at the
pod shape and the decode step); in phase 4
zamba2 at full width and all 38 layers on the pod path
(``zamba2_pod_path``: ama_fes and fedavg, then masked with --no-scan;
launches from ``plan_launches`` over both kernel families, 152
mamba2_fwd, 76 mamba2_bwd and 12 of each flash kernel a round; server_mix
2 a round; peak, tokens/s over rounds 2-3) and served at 38 layers per
token twice through the loop engine, the same tokens both times
(``zamba2_serving``); in phases 5-6 the reduced zamba2 at 6 layers card
== CPU on both client planes, chunked == per round and remat on == off
bitwise (``zamba2_reduced_on_card``); in phase 7 a 2-round profile with
the mamba2 kernels' and flash's shares and the device time of the
recurrence's and the shared attention's profiler ranges
(``zamba2_where_time_goes``). The mamba2 kernels' device kernels a call
are traced in a process of their own (``mamba2_kernels_fresh``), and
every profiler session of the run keeps CUPTI set up between sessions
(``TEARDOWN_CUPTI`` = 0, as PyTorch sets it where CUDA graphs are
captured: the run captures them for its timings).
Slice 19 redesigns the two mamba2 kernels in the chunked SSD form with
their products on the tensor cores in 3xTF32: ``check_mamba2`` adds
exact zeros in a and a = 1 to its cases, holds h_final and the states to
the 1e-5 rule (no longer bitwise: a chunk boundary sums in another order
than the per-step recurrence), the backward on the kernel's own states
against the plain backward on the plain states, and two calls bitwise;
``time_mamba2`` takes the kernels' bound at the tensor cores' tf32 rate
for the chunk form's products in three passes (``mamba2_design_flops``),
prints the per-step recurrence's f32-rate figure beside it, and traces
three device kernels a forward call and four a backward call.
Slice 20 (the vlm, phi-3-vision-4.2b, and the encoder-decoder,
whisper-medium) adds: in phase 3 the flash kernels at any length and at
q against k, v of another length (``check_flash``: the vlm's 2,624 rows
at hd 96, whisper's encoder over 1,500 frames non-causal, its
cross-attention 2,048 x 1,500 and one row x 1,500, ragged S 129 and 200
on both designs, the three new shapes timed beside SDPA; a causal or
windowed q against k, v of another length refused), serve_attention at
the vlm's hd 96 with n_rep 1 and its cross form
(``check_serve_cross``: c 1, 8 and 64 over 1,500 keys, bf16 and f32,
every chunk row bitwise the c = 1 row, timed beside SDPA),
invariant_dense at both families' serving projections (whisper's lm_head
padded to 51,872 columns) and invariant_rmsnorm at d 3072 and 1024; in
phase 4 both at full width on the pod path, the vlm at 24 of its 32
layers (32 ran out of memory after the earlier phases), whisper at all
24 + 24 (``slice20_pod_paths``: ama_fes and fedavg masked, whisper's remat off
bitwise, then partitioned at p_limited 0.5; the depth, parameters and
peak printed) and served (``slice20_serving``: the vlm paged twice and
by the loop engine per token twice and chunked 64, whisper by the loop
engine the same way with its frames encoded once a run, every run the
first run's tokens; whisper's paged engine refused); in phases 5-6 the
reduced vlm and whisper (100 frames) card == CPU on both client planes,
chunked == per round and remat on == off, bitwise
(``slice20_reduced_on_card``); in phase 7 a 2-round profile of whisper
with the device time of its encoder's, decoder's and cross-attention's
profiler ranges and of the flash kernels in each
(``whisper_where_time_goes``). The kernels line gains
``serve_cross_attention``.
Slice 21, the sharded client axis (phase 8, after minitron-8b's pod
path, the parent's reserved memory printed first): (a) W = 1 over NCCL
in this process, minitron-8b at full width as its pod path ran it,
rows gathered (``--client-reduce off``) over a one-rank group: params
and losses bitwise the meshless run, the ``collective`` span printed
(``sharded_nccl_w1``); (b) W = 2 ranks sharing the card over gloo, one
spawn running the paper CNN at K 50, m 10 for 5 rounds under ama_fes,
async_ama (max_delay 3), fedavg, fedprox and fedopt, each "off" and
"auto": "off" bitwise the one-process run whose client plane runs the
same two cohort blocks (``BlockedPlane``: cuBLAS and cuDNN give a
cohort's rows other bits in a call of 5 cohorts than of 10) and within
the pre-reduced axis' tolerance of the plain one, "auto" within that
tolerance (fedopt at FEDOPT_RUN_TOL), both ranks bitwise the same state;
(c) W = 2 over NCCL, one card a rank, where the machine has two cards,
else a line saying why not (``sharded_runs``). The children's launches
join the kernels line.
The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Needs a CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12        # H100 SXM tf32 tensor cores, dense
MAIN_N = 54_784                  # the paper CNN's parameter count
MAIN_K = 5                       # quickstart: 5 clients per round
MAIN_Q = 11                      # async at max_delay 10
N_ULP = {"float32": 4, "bfloat16": 1}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ----------------------------------------------------------------- timing --

def device_ms(torch, fn, reps: int = 10, replays: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times after warm-up, each
    replay timed with CUDA events; the median replay over ``reps``. The
    graph keeps the Python wrapper's host time out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def call_ms(torch, fn, iters: int = 20) -> float:
    """Median time of one eager call (CUDA events), the Python wrapper's
    host time included: what a caller that waits on it sees."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def slow_ms(torch, fn) -> float:
    """``device_ms`` at one call a graph and 3 replays, or, where one eager
    call takes more than 50 ms (a plain version that loops), the median
    of 2 eager calls (CUDA events; the host's share is nothing there)."""
    first = call_ms(torch, fn, iters=1)
    if first > 50:
        return call_ms(torch, fn, iters=2)
    return device_ms(torch, fn, reps=1, replays=3)


class PhaseClock:
    """Prints each phase's wall seconds as the script passes its end (the
    run's own breakdown against its time limit)."""

    def __init__(self, t0: float):
        self.t = t0

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase time: {phase} {now - self.t:.1f} s", flush=True)
        self.t = now


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------- tolerance --

def ulp(torch, x, dtype):
    """Spacing of ``dtype`` at |x| (x in f32); zeros get the spacing of
    the smallest normal."""
    mant = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    m, e = torch.frexp(torch.clamp(x.abs().float(), min=tiny))
    return torch.ldexp(torch.ones_like(m), e - 1 - mant)


def compare(torch, name, got, want, mag, dtype) -> float:
    """|got - want| <= n ulp of ``dtype`` at the magnitude ``mag`` of the
    summed terms (the plain version run on the absolute inputs: a sum's
    rounding scales with its terms, not with its result)."""
    n = N_ULP[str(dtype).split(".")[-1]]
    err = (got.float() - want.float()).abs()
    tol = n * ulp(torch, mag, dtype)
    bad = err > tol
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0]) if bad.ndim == 1 else -1
        fail(f"{name}: {int(bad.sum())} elements beyond {n} ulp "
             f"(max err {float(err.max()):.3e}; first bad index {i})")
    return float(err.max())


# ------------------------------------------------------------ phase 3 -----

MIX_VEC_N = 33_554_432           # a multiple of the 16-byte vector


def mix_design(sp, fn, designs="server_mix_designs"):
    """(fn(), the kernel that one fn() call launched: "vector" or
    "per_element", from the C entry's counts; ``designs`` names the
    reader, server_mix's or server_async's)."""
    read = getattr(sp, designs)
    before = read()
    out = fn()
    after = read()
    moved = [d for d in after if after[d] != before[d]]
    check(len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1,
          f"{designs}: one call launched {after} - {before}")
    return out, moved[0]


def check_server_mix(torch, sp, ref, record):
    """server_mix against its plain version, bitwise in every case, each
    case naming the kernel it took (the 16-byte vector kernel where N is a
    multiple of the vector, 4 f32 or 8 bf16, and every operand is 16-byte
    aligned; the per-element kernel otherwise): N = 54,784 (the CNN's,
    vector), 1,000,003 and 33,554,437 (per element), 33,554,432
    (vector), and 54,784 with prev, stacked and out offset by one element
    (per element)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    print("server_mix: K, N, dtype, case, kernel | kernel device ms, GB/s "
          "(share of 3.35 TB/s), bound ms | plain device ms | library "
          "device ms (addmv) | eager call ms (wrapper host time included)")
    cases = [(K, N, dt, "t=7") for N in (MAIN_N, 1_000_003, 33_554_437)
             for K in (1, 5, 10) for dt in (torch.float32, torch.bfloat16)]
    cases += [(5, MAIN_N, torch.float32, "nobody kept"),
              (5, MAIN_N, torch.bfloat16, "alpha at cap"),
              (10, 1_000_003, torch.float32, "alpha at cap")]
    cases += [(K, MIX_VEC_N, dt, "t=7") for K in (5, 10)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(5, MAIN_N, dt, "offset 1") for dt in (torch.float32,
                                                     torch.bfloat16)]
    for K, N, dt, case in cases:
        off = 1 if case == "offset 1" else 0
        prev = torch.randn(N + off, device=dev, generator=g).to(dt)[off:]
        stacked = torch.randn(K * N + off, device=dev,
                              generator=g).to(dt)[off:].view(K, N)
        sizes = torch.rand(K, device=dev, generator=g) + 0.5
        keep = (torch.rand(K, device=dev, generator=g) < 0.7).float()
        keep[0] = 1.0
        if case == "nobody kept":
            keep.zero_()
        t = 400.0 if case == "alpha at cap" else 7.0  # 0.1 + 2.5e-3 t > 0.95
        coefs = torch.tensor([0.1, 2.5e-3, 0.95, t], device=dev)
        got, design = mix_design(sp, lambda: sp.server_mix_flat(
            prev, stacked, sizes, keep, coefs))
        want_design = ("vector" if N % (16 // prev.element_size()) == 0
                       and not off else "per_element")
        check(design == want_design, f"server_mix K={K} N={N} {dt} {case}: "
              f"took the {design} kernel, expected {want_design}")
        want = ref.server_mix_math(prev, stacked, sizes, keep, coefs)
        mag = ref.server_mix_math(prev.float().abs(), stacked.float().abs(),
                                  sizes, keep, coefs)
        torch.cuda.synchronize()
        err = compare(torch, f"server_mix K={K} N={N} {dt} {case}", got,
                      want, mag, dt)
        exact = torch.equal(got, want)
        check(exact, f"server_mix K={K} N={N} {dt} {case}: not bitwise "
              "equal to the plain version")
        s = prev.element_size()
        nbytes = (K + 2) * N * s + 2 * K * 4 + 16

        def timed():
            return sp.server_mix_flat(prev, stacked, sizes, keep, coefs)
        ms, eager = device_ms(torch, timed), call_ms(torch, timed)
        plain = device_ms(torch, lambda: ref.server_mix_math(
            prev, stacked, sizes, keep, coefs))
        lib = None
        if dt == torch.float32:
            alpha = min(0.1 + 2.5e-3 * t, 0.95)
            w = sizes * keep
            tot = float(w.sum())
            vec = (1.0 - alpha) * w / max(tot, 1e-9)
            a_eff = alpha if tot > 0 else 1.0
            lib = device_ms(torch, lambda: torch.addmv(prev, stacked.T, vec,
                                                       beta=a_eff))
        gbs = nbytes / (ms * 1e-3) / 1e9
        bnd, _ = bound_ms(nbytes, (2 * K + 1) * N)
        print(f"  K={K:2d} N={N:>10,} {str(dt)[6:]:8s} {case:11s} "
              f"{design:11s} | {ms:8.4f} ms {gbs:7.1f} GB/s "
              f"({gbs / 3350:5.1%}) bound {bnd:.4f} | "
              f"plain {plain:8.4f} | lib "
              f"{'-' if lib is None else f'{lib:.4f}'} | eager call "
              f"{eager:.4f} | err {err:.2e}")
        record.append(dict(K=K, N=N, dtype=str(dt), case=case, ms=ms,
                           design=design, call_ms=eager, exact=exact,
                           plain_ms=plain, library_ms=lib, err=err,
                           nbytes=nbytes, flops=(2 * K + 1) * N))
        del prev, stacked


#: server_async's cases beside the main shape (K, Q, N, dtype, case):
#: "t" on aligned operands, "offset 1" with prev one element past an
#: aligned base (the per-element kernel at the vector kernel's shapes)
ASYNC_CASES = (
    [(10, Q, N, dt, "t") for N in (MAIN_N, 8_388_617) for Q in (2, 11, 21)
     for dt in ("float32", "bfloat16")]
    + [(MAIN_K, MAIN_Q, MAIN_N, "float32", "offset 1"),
       (MAIN_K, MAIN_Q, 33_554_437, "float32", "t"),
       (MAIN_K, MAIN_Q, MIX_VEC_N, "float32", "t"),
       (MAIN_K, MAIN_Q, MIX_VEC_N, "float32", "offset 1"),
       (2, MAIN_Q, MAIN_N, "bfloat16", "t"),
       (8, 21, 8_388_608, "bfloat16", "t"),
       (1, 2, MAIN_N, "float32", "t")]
    # slice 12's main paths: the scenarios' rings (clear Q 2,
    # bursty-severe Q 16) and the federation-scale cohorts at Q 7
    + [(MAIN_K, Q, MAIN_N, "float32", "t") for Q in (2, 16)]
    + [(K, 7, MAIN_N, "float32", "t") for K in (5, 32, 128)])


def check_server_async(torch, sp, ref, record):
    """server_async against its plain version, bitwise in every round of
    every case (the ring wraps three times; every seventh round nobody is
    on time), each case naming the kernel it took: the 16-byte vector
    kernel where K <= 8, N is a multiple of the vector and every operand
    is aligned (the main shape K 5, Q 11, N 54,784 f32 among them), the
    per-element kernel otherwise (K 10, a ragged N, prev offset by one
    element; slice 12's rings Q 2 and 16 at K 5, and the federation
    cohorts K 5, 32, 128 at Q 7). Both kernels are timed at the main
    shape and at N =
    33,554,432 (vector) / 33,554,437 (per element) and 33,554,432 with
    prev offset."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    print("server_async: K, Q, N, dtype, case, kernel over 3Q rounds | "
          "kernel device ms, GB/s, bound ms | plain device ms | eager "
          "call ms")
    cases = [(MAIN_K, MAIN_Q, MAIN_N, "float32", "t"), *ASYNC_CASES]
    hyp = torch.tensor([0.1, 2.5e-3, 0.95, 0.6], device=dev)
    for K, Q, N, dts, case in cases:
        dt = getattr(torch, dts)
        off = 1 if case == "offset 1" else 0
        base = torch.randn(N + off, device=dev, generator=g).to(dt)
        prev = base[off:]
        qsum = torch.zeros(Q, N, device=dev)
        qgamma = torch.zeros(Q, device=dev)
        sizes = torch.rand(K, device=dev, generator=g) + 0.5
        err, exact, designs = 0.0, True, set()
        for t in range(3 * Q):          # the ring wraps three times
            stacked = (prev.float()[None] + 0.1 * torch.randn(
                K, N, device=dev, generator=g)).to(dt)
            delayed = (torch.rand(K, device=dev, generator=g) < 0.3).float()
            if t % 7 == 3:
                delayed.fill_(1.0)      # nobody on time this round
            delays = torch.randint(1, max(Q - 1, 1) + 1, (K,), device=dev,
                                   generator=g, dtype=torch.int32)
            delays = torch.where(delayed > 0, delays, 1).to(torch.int32)
            tq = torch.tensor([t, t % Q], device=dev, dtype=torch.int32)
            args = (prev, stacked, qsum, qgamma, sizes, delayed, delays, tq,
                    hyp)
            got, design = mix_design(
                sp, lambda: sp.server_async_flat(*args),
                "server_async_designs")
            designs.add(design)
            want = ref.server_async_math(*args)
            mag = ref.server_async_math(prev.float().abs(),
                                        stacked.float().abs(), qsum.abs(),
                                        qgamma, sizes, delayed, delays, tq,
                                        hyp)
            torch.cuda.synchronize()
            tag = f"server_async K={K} Q={Q} N={N} {dt} {case} t={t}"
            err = max(err,
                      compare(torch, tag + " out", got[0], want[0], mag[0],
                              dt),
                      compare(torch, tag + " qsum", got[1], want[1], mag[1],
                              torch.float32),
                      compare(torch, tag + " qgamma", got[2], want[2],
                              mag[2], torch.float32))
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            check(exact, f"{tag}: not bitwise equal to the plain version")
            del got, mag
            if t == Q:
                ms = device_ms(torch, lambda: sp.server_async_flat(*args))
                eager = call_ms(torch, lambda: sp.server_async_flat(*args))
                plain = device_ms(torch,
                                  lambda: ref.server_async_math(*args),
                                  reps=2, replays=20)
            # the next round's operands: prev at the case's offset
            base = torch.empty(N + off, device=dev, dtype=dt)
            prev = base[off:]
            prev.copy_(want[0])
            qsum, qgamma = want[1], want[2]
            del want
        vec = (K <= 8 and N % (16 // prev.element_size()) == 0 and not off)
        want_design = "vector" if vec else "per_element"
        check(designs == {want_design}, f"server_async K={K} Q={Q} N={N} "
              f"{dt} {case}: took {designs}, expected {want_design}")
        s = prev.element_size()
        nbytes = (K + 2) * N * s + 2 * Q * N * 4 + (3 * K + 2 * Q + 6) * 4
        flops = (2 * K + 2 * K * Q + 3 * Q + 3) * N
        gbs = nbytes / (ms * 1e-3) / 1e9
        print(f"  K={K:2d} Q={Q:2d} N={N:>10,} {dts:8s} {case:8s} "
              f"{want_design:11s} | {ms:8.4f} ms {gbs:7.1f} GB/s "
              f"({gbs / 3350:5.1%}) bound {bound_ms(nbytes, flops)[0]:.4f} | "
              f"plain {plain:8.4f} | eager call {eager:.4f} | err {err:.2e}"
              " bitwise")
        record.append(dict(K=K, Q=Q, N=N, dtype=str(dt), case=case,
                           design=want_design, ms=ms, call_ms=eager,
                           exact=exact, plain_ms=plain, library_ms=None,
                           err=err, nbytes=nbytes, flops=flops))
        del prev, base, stacked, qsum


BIG_N = 33_554_437               # operands well beyond the 50 MB L2
MAIN_KK = 547                    # top-k at 1% of MAIN_N


def _weights(torch, g, K, case):
    dev = torch.device("cuda")
    sizes = torch.rand(K, device=dev, generator=g) + 0.5
    keep = (torch.rand(K, device=dev, generator=g) < 0.7).float()
    keep[0] = 1.0
    if case == "nobody kept":
        keep.zero_()
    return sizes, keep


def _report(tag, ms, eager, plain, lib, nbytes, flops, err, exact, record,
            **key):
    gbs = nbytes / (ms * 1e-3) / 1e9
    bnd, _ = bound_ms(nbytes, flops)
    print(f"  {tag} | {ms:8.4f} ms {gbs:7.1f} GB/s ({gbs / 3350:5.1%}) "
          f"bound {bnd:.4f} | plain {plain:8.4f} | lib "
          f"{'-' if lib is None else f'{lib:.4f}'} | eager call "
          f"{eager:.4f} | err {err:.2e} {'bitwise' if exact else ''}")
    record.append(dict(key, ms=ms, call_ms=eager, plain_ms=plain,
                       library_ms=lib, err=err, exact=exact, nbytes=nbytes,
                       flops=flops))


def vector_expected(off, N, *tensors) -> str:
    """The kernel a layout must take: "vector" where N is a multiple of
    16 bytes of the narrowest operand and no base pointer is offset,
    "per_element" otherwise."""
    unit = 16 // min(t.element_size() for t in tensors)
    return "vector" if N % unit == 0 and not off else "per_element"


def check_server_adam(torch, sp, ref, record):
    """FedOpt server-Adam: three outputs, the bias corrections from powf
    in the kernel's prologue against PyTorch's pow on the card; bitwise in
    every case, each naming the kernel it took (16-byte where N is a
    multiple of prev's vector and the operands are aligned: the main
    shape, N = 16, whose one vector a call shows the latency floor, and
    N = 33,554,432; per element at N + 1, 33,554,437 and with prev
    offset by one element)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    print("server_adam: K, N, dtype, case, kernel | kernel device ms, GB/s, "
          "bound ms | plain device ms | library: none (no single call) | "
          "eager call ms")
    cases = [(5, MAIN_N, torch.float32, "step 1"),
             (5, MAIN_N, torch.float32, "step 37"),
             (5, MAIN_N, torch.bfloat16, "step 37"),
             (5, MAIN_N, torch.float32, "nobody kept"),
             (5, MAIN_N, torch.float32, "offset 1"),
             (5, 16, torch.float32, "step 37"),
             (1, MAIN_N + 1, torch.float32, "step 3"),
             (10, BIG_N, torch.float32, "step 37"),
             (10, BIG_N, torch.bfloat16, "step 37"),
             (10, MIX_VEC_N, torch.float32, "step 37"),
             (10, MIX_VEC_N, torch.bfloat16, "step 37")]
    for K, N, dt, case in cases:
        off = 1 if case == "offset 1" else 0
        prev = torch.randn(N + off, device=dev, generator=g).to(dt)[off:]
        stacked = (prev.float()[None] + 0.01 * torch.randn(
            K, N, device=dev, generator=g)).to(dt)
        m = 1e-3 * torch.randn(N, device=dev, generator=g)
        v = 1e-6 * torch.rand(N, device=dev, generator=g)
        sizes, keep = _weights(torch, g, K, case)
        step = float(case.split()[-1]) if case.startswith("step") else 5.0
        sc = torch.tensor([0.9, 0.99, 0.1, 1e-3, step], device=dev)
        args = (prev, stacked, m, v, sizes, keep, sc)
        got, design = mix_design(sp, lambda: sp.server_adam_flat(*args),
                                 "server_adam_designs")
        want = ref.server_adam_math(*args)
        torch.cuda.synchronize()
        tag = f"K={K:2d} N={N:>10,} {str(dt)[6:]:8s} {case:11s} {design:11s}"
        want_design = vector_expected(off, N, prev)
        check(design == want_design, f"server_adam {tag}: expected the "
              f"{want_design} kernel")
        err = max(compare(torch, f"server_adam {tag} out", got[0], want[0],
                          want[0].float().abs() + prev.float().abs(), dt),
                  compare(torch, f"server_adam {tag} m", got[1], want[1],
                          want[1].abs(), torch.float32),
                  compare(torch, f"server_adam {tag} v", got[2], want[2],
                          want[2].abs(), torch.float32))
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        check(exact, f"server_adam {tag}: not bitwise equal to the plain "
              "version")
        del got, want
        ms = device_ms(torch, lambda: sp.server_adam_flat(*args))
        eager = call_ms(torch, lambda: sp.server_adam_flat(*args))
        plain = device_ms(torch, lambda: ref.server_adam_math(*args),
                          reps=2)
        s = prev.element_size()
        _report(tag, ms, eager, plain, None,
                (K + 2) * N * s + 16 * N + 2 * K * 4 + 20, (2 * K + 14) * N,
                err, exact, record, K=K, N=N, dtype=str(dt), case=case,
                design=design)
        del prev, stacked, m, v


def check_server_mix_delta(torch, sp, ref, record):
    """The mix over int8 / bf16 delta rows, de-quantized in-kernel; bitwise
    in every case, each naming the kernel it took (16-byte where N is a
    multiple of 16 bytes of the narrower of prev and the rows, 16
    elements under int8 rows, and the operands are aligned: the main
    shape, N = 16 (the latency floor) and N = 33,554,432; per element at
    N + 1, 33,554,437 and with prev offset by one element)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    print("server_mix_delta: K, N, prev dtype, rows, case, kernel | kernel "
          "device ms, GB/s, bound ms | plain device ms | library: none (no "
          "single call takes int8 rows) | eager call ms")
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    cases = [(5, MAIN_N, f32, i8, "t=7"), (5, MAIN_N, f32, bf16, "t=7"),
             (5, MAIN_N, bf16, i8, "t=7"), (5, MAIN_N, f32, i8, "nobody kept"),
             (5, MAIN_N, f32, i8, "offset 1"), (5, 16, f32, i8, "t=7"),
             (1, MAIN_N + 1, f32, i8, "t=7"), (10, BIG_N, f32, i8, "t=7"),
             (10, BIG_N, f32, bf16, "t=7"), (10, MIX_VEC_N, f32, i8, "t=7"),
             (10, MIX_VEC_N, f32, bf16, "t=7")]
    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 7.0], device=dev)
    for K, N, dt, rt, case in cases:
        off = 1 if case == "offset 1" else 0
        prev = torch.randn(N + off, device=dev, generator=g).to(dt)[off:]
        if rt == i8:
            rows = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                                 dtype=i8)
            rs = torch.rand(K, device=dev, generator=g) * 1e-3
        else:
            rows = (0.01 * torch.randn(K, N, device=dev, generator=g)).to(rt)
            rs = torch.ones(K, device=dev)
        sizes, keep = _weights(torch, g, K, case)
        args = (prev, rows, rs, sizes, keep, coefs)
        got, design = mix_design(sp, lambda: sp.server_mix_delta_flat(*args),
                                 "server_mix_delta_designs")
        want = ref.server_mix_delta_math(*args)
        mag = ref.server_mix_delta_math(prev.float().abs(), rows.float().abs(),
                                        rs, sizes, keep, coefs)
        torch.cuda.synchronize()
        tag = (f"K={K:2d} N={N:>10,} {str(dt)[6:]:8s} {str(rt)[6:]:8s} "
               f"{case:11s} {design:11s}")
        want_design = vector_expected(off, N, prev, rows)
        check(design == want_design, f"server_mix_delta {tag}: expected the "
              f"{want_design} kernel")
        err = compare(torch, f"server_mix_delta {tag}", got, want, mag, dt)
        exact = torch.equal(got, want)
        check(exact, f"server_mix_delta {tag}: not bitwise equal to the "
              "plain version")
        del got, want, mag
        ms = device_ms(torch, lambda: sp.server_mix_delta_flat(*args))
        eager = call_ms(torch, lambda: sp.server_mix_delta_flat(*args))
        plain = device_ms(torch, lambda: ref.server_mix_delta_math(*args),
                          reps=2)
        nbytes = 2 * N * prev.element_size() + K * N * rows.element_size() \
            + 3 * K * 4 + 16
        _report(tag, ms, eager, plain, None, nbytes, (2 * K + 1) * N, err,
                exact, record, K=K, N=N, dtype=str(dt), rows=str(rt),
                case=case, design=design)
        del prev, rows


#: profiler sessions ``device_kernels`` opens before it takes a trace
#: with no device activity at all as the answer
TRACE_TRIES = 3

#: every ``device_kernels`` call: (its caller's label, the profiler
#: sessions it opened, how many of them traced no device activity),
#: summed up in one line at the end of the run
TRACE_LOG: list = []


def device_kernels(torch, fn, label: str) -> list[str]:
    """Names of the device kernels one ``fn()`` call runs
    (``device_events``)."""
    return [name for name, _ in device_events(torch, fn, label)]


def device_events(torch, fn, label: str) -> list[tuple[str, float]]:
    """(name, microseconds) of each device kernel one ``fn()`` call runs,
    from a torch.profiler trace (kernels, copies and sets on the card). The
    session traces one warm-up call first and discards it (the
    profiler's ``warmup`` step): a trace that starts cold can drop the
    first kernel of the session. A trace that holds no device activity
    at all is taken again, up to ``TRACE_TRIES`` sessions: the profiler
    has returned one with the call's only kernel missing, from a call
    whose output had just matched its plain version. A trace that holds
    any device event is the answer as it stands, so an extra or a
    missing kernel beside another still fails the caller's check.
    ``label`` names the call in ``TRACE_LOG``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    empty = 0
    for attempt in range(1, TRACE_TRIES + 1):
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(
                             str(path))) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            events = json.loads(path.read_text())["traceEvents"]
        names = [(e["name"], float(e.get("dur", 0.0))) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if names:
            break
        empty += 1
        print(f"  device_kernels: profiler session {attempt} of "
              f"{TRACE_TRIES} ({label}) traced no device activity")
    TRACE_LOG.append((label, attempt, empty))
    return names


def trace_summary() -> str:
    """The one line on the profiler sessions ``device_kernels`` opened:
    how many met no device activity, and which call each came from."""
    met = [(label, n) for label, _, n in TRACE_LOG if n]
    return (f"device_kernels: {len(TRACE_LOG)} calls, "
            f"{sum(s for _, s, _ in TRACE_LOG)} profiler sessions, "
            f"{sum(n for _, n in met)} of them with no device activity"
            + (f": {met}" if met else ""))


def check_server_mix_scatter(torch, sp, ref, record):
    """The mix over top-k pairs: one cooperative launch a call, counted
    in a profiler trace of one call of every case; positions collide
    across clients (half of each row with the row before; in the K-fold
    case every row holds the same positions in another order), and K
    reaches the kernel's table limit (256)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    print("server_mix_scatter: K, N, kk, dtype, case | kernel device ms "
          "(one launch), GB/s, bound ms | plain device ms | library "
          "(index_add on pre-scaled operands) | eager call ms")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(5, MAIN_N, MAIN_KK, f32, "t=7"), (5, MAIN_N, MAIN_KK, bf16, "t=7"),
             (5, MAIN_N, MAIN_KK, f32, "nobody kept"),
             (1, MAIN_N + 1, MAIN_KK, f32, "t=7"),
             (5, MAIN_N, MAIN_KK, f32, "K-fold"),
             (sp.MAX_K, MAIN_N, MAIN_KK, f32, "K = 256"),
             (10, BIG_N, 335_544, f32, "t=7"), (10, BIG_N, 335_544, bf16, "t=7")]
    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 7.0], device=dev)
    for K, N, kk, dt, case in cases:
        prev = torch.randn(N, device=dev, generator=g).to(dt)
        perm = torch.randperm(N, device=dev, generator=g)
        if case == "K-fold":   # one set of positions, K orders of it
            idx = torch.stack([perm[:kk][torch.randperm(
                kk, device=dev, generator=g)] for _ in range(K)])
        else:   # rows are windows of one permutation shifted by kk/2
            # (mod N): distinct within a row, half of each row collides
            # with the row before
            idx = torch.stack([perm[(k * kk // 2 + torch.arange(
                kk, device=dev)) % N] for k in range(K)])
        idx = idx.to(torch.int32)
        vals = 0.01 * torch.randn(K, kk, device=dev, generator=g)
        sizes, keep = _weights(torch, g, K, case)
        args = (prev, vals, idx, sizes, keep, coefs)
        got = sp.server_mix_scatter_flat(*args)
        want = ref.server_mix_scatter_math(*args)
        mag = ref.server_mix_scatter_math(prev.float().abs(), vals.abs(), idx,
                                          sizes, keep, coefs)
        torch.cuda.synchronize()
        tag = f"K={K:3d} N={N:>10,} kk={kk:>7,} {str(dt)[6:]:8s} {case:11s}"
        err = compare(torch, f"server_mix_scatter {tag}", got, want, mag, dt)
        exact = torch.equal(got, want)
        check(exact, f"server_mix_scatter {tag}: not bitwise equal to the "
              "plain version")
        del got, want, mag
        names = device_kernels(torch,
                               lambda: sp.server_mix_scatter_flat(*args),
                               f"server_mix_scatter {case}")
        check(len(names) == 1 and "server_mix_scatter" in names[0],
              f"server_mix_scatter {tag}: one call ran {len(names)} device "
              f"kernels {names}, expected exactly one")
        ms = device_ms(torch, lambda: sp.server_mix_scatter_flat(*args))
        eager = call_ms(torch, lambda: sp.server_mix_scatter_flat(*args))
        plain = device_ms(torch, lambda: ref.server_mix_scatter_math(*args),
                          reps=2)
        lib = None
        if dt == f32:
            alpha = min(0.1 + 2.5e-3 * 7.0, 0.95)
            w = sizes * keep
            tot = float(w.sum())
            bw = (1.0 - alpha) * w / max(tot, 1e-9)
            c = (alpha if tot > 0 else 1.0) + (1.0 - alpha) * float(
                (w / max(tot, 1e-9)).sum())
            base = prev * c
            flat_idx = idx.reshape(-1).long()
            src = (vals * bw[:, None]).reshape(-1)
            lib = device_ms(torch, lambda: torch.index_add(base, 0, flat_idx,
                                                           src))
        nbytes = 2 * N * prev.element_size() + K * kk * 8 + 2 * K * 4 + 16
        _report(tag, ms, eager, plain, lib, nbytes, N + 2 * K * kk, err,
                exact, record, K=K, N=N, kk=kk, dtype=str(dt), case=case)
        del prev, vals, idx, perm


#: the paper CNN's 8 leaves in jax.tree order (the legacy chain mixes
#: all of them in one ama_mix launch a round): conv1/w, conv2/w, fc1 b/w,
#: fc2 b/w, fc3 b/w
LEAF_SIZES = (250, 5000, 120, 38400, 84, 10080, 10, 840)


def check_ama_mix(torch, am, ref, record):
    """ama_mix against ama_mix_math, bitwise in every case. One leaf a
    call (``ama_mix_flat``): K = 1 at every leaf size of the paper CNN
    and at its whole size, K = 2 over the async operand (f32 rows under
    f32 and bf16 prev), K = 1 with alpha = 1 (fedopt), a ragged N, N =
    33,554,437 and 33,554,432. Then many leaves a call
    (``check_ama_mix_leaves``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    print("ama_mix: K, N, prev/rows dtype, case | kernel device ms, GB/s, "
          "bound ms | plain device ms | library device ms (addmv) | eager "
          "call ms")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, N, dt, dt, "leaf") for dt in (f32, bf16)
             for N in LEAF_SIZES]
    cases += [(1, MAIN_N, f32, f32, "whole"), (1, MAIN_N, bf16, bf16, "whole"),
              (2, 38400, f32, f32, "async"), (2, 38400, bf16, f32, "async"),
              (1, 38400, f32, f32, "fedopt"), (2, MAIN_N + 1, f32, f32,
                                                "ragged"),
              (1, BIG_N, f32, f32, "big"), (1, BIG_N, bf16, bf16, "big"),
              (2, BIG_N, f32, f32, "big"), (2, BIG_N, bf16, f32, "big"),
              (2, MIX_VEC_N, f32, f32, "big vec")]
    for K, N, pdt, sdt, case in cases:
        prev = torch.randn(N, device=dev, generator=g).to(pdt)
        stacked = torch.randn(K, N, device=dev, generator=g).to(sdt)
        a = 1.0 if case == "fedopt" else 0.1 + 0.8 * float(
            torch.rand(1, generator=g, device=dev))
        alpha = torch.full((1,), a, device=dev)
        w = torch.rand(K, device=dev, generator=g)
        args = (prev, stacked, alpha, w)
        got = am.ama_mix_flat(*args)
        want = ref.ama_mix_math(*args)
        mag = ref.ama_mix_math(prev.float().abs(), stacked.float().abs(),
                               alpha, w)
        torch.cuda.synchronize()
        tag = (f"K={K} N={N:>10,} {str(pdt)[6:]:8s} {str(sdt)[6:]:8s} "
               f"{case:6s}")
        err = compare(torch, f"ama_mix {tag}", got, want, mag, pdt)
        exact = torch.equal(got, want)
        check(exact, f"ama_mix {tag}: not bitwise equal to ama_mix_math "
              f"(max err {err:.3e})")
        del got, want, mag
        ms = device_ms(torch, lambda: am.ama_mix_flat(*args))
        eager = call_ms(torch, lambda: am.ama_mix_flat(*args))
        plain = device_ms(torch, lambda: ref.ama_mix_math(*args),
                          reps=2 if N == BIG_N else 10)
        lib = None
        if pdt == sdt == f32:
            lib = device_ms(torch, lambda: torch.addmv(prev, stacked.T, w,
                                                       beta=a))
        nbytes = (2 * N * prev.element_size() + K * N * stacked.element_size()
                  + (K + 1) * 4)
        _report(tag, ms, eager, plain, lib, nbytes, (2 * K + 1) * N, err,
                exact, record, K=K, N=N, dtype=str(pdt), rows=str(sdt),
                case=case)
        del prev, stacked
    check_ama_mix_leaves(torch, am, ref, record)


#: ama_mix_leaves' cases: (case, leaf sizes, prev dtypes, rows dtypes, K,
#: the leaves offset by one element, the launches expected)
LEAVES_CASES = [
    ("CNN", LEAF_SIZES, ["float32"] * 8, ["float32"] * 8, 1, (), 1),
    ("CNN", LEAF_SIZES, ["bfloat16"] * 8, ["bfloat16"] * 8, 1, (), 1),
    ("CNN async", LEAF_SIZES, ["float32"] * 8, ["float32"] * 8, 2, (), 1),
    ("CNN async", LEAF_SIZES, ["bfloat16"] * 8, ["float32"] * 8, 2, (), 1),
    ("split", tuple(5 + 37 * j for j in range(100)), ["float32"] * 100,
     ["float32"] * 100, 1, (), 2),
    ("mixed", LEAF_SIZES, ["float32", "bfloat16"] * 4,
     ["float32", "bfloat16"] * 4, 2, (), 2),
    ("unaligned", LEAF_SIZES, ["float32"] * 8, ["float32"] * 8, 1, (3,), 1),
]


def check_ama_mix_leaves(torch, am, ref, record):
    """ama_mix_leaves against ama_mix_leaves_math, bitwise in every case,
    each call's launches counted: the paper CNN's 8 leaves in one launch
    (K = 1 in f32 and bf16; K = 2 as the async chain calls it, f32 rows
    under f32 and bf16 prev), 100 leaves in 2 (a table holds 64), two
    dtype pairs in 2, and the CNN with its largest leaf offset by one
    element (that leaf on the per-element path). Timed by graph replay
    and by an eager call; the library yardstick is one addmv a leaf."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    print("ama_mix_leaves: case, leaves, prev/rows dtypes, K | launches, "
          "16-byte leaves | kernel device ms, GB/s, bound ms | plain | "
          "library (addmv a leaf) | eager call ms")
    for case, sizes, pdts, sdts, K, offset, launches in LEAVES_CASES:
        prevs, stackeds = [], []
        for j, (n, pd, sd) in enumerate(zip(sizes, pdts, sdts)):
            o = int(j in offset)
            prevs.append(torch.randn(n + o, device=dev, generator=g).to(
                getattr(torch, pd))[o:])
            stackeds.append(torch.randn(K * n + o, device=dev, generator=g)
                            .to(getattr(torch, sd))[o:].view(K, n))
        a = 0.1 + 0.8 * float(torch.rand(1, generator=g, device=dev))
        alpha = torch.full((1,), a, device=dev)
        w = torch.rand(K, device=dev, generator=g)
        args = (prevs, stackeds, alpha, w)
        before = am.ama_mix_leaves.launches
        got = am.ama_mix_leaves(*args)
        n_launch = am.ama_mix_leaves.launches - before
        plan = am.leaf_launches(prevs, stackeds, got)
        want = ref.ama_mix_leaves_math(*args)
        mag = ref.ama_mix_leaves_math([p.float().abs() for p in prevs],
                                      [x.float().abs() for x in stackeds],
                                      alpha, w)
        torch.cuda.synchronize()
        short = {"float32": "f32", "bfloat16": "bf16"}
        pair = f"{short[pdts[0]]}/{short[sdts[0]]}" + (
            "+" if len(set(pdts)) > 1 else "")
        tag = f"{case:9s} {len(sizes):3d} leaves {pair:10s} K={K}"
        check(n_launch == launches and len(plan) == launches,
              f"ama_mix_leaves {tag}: {n_launch} launches, expected "
              f"{launches}")
        err, exact = 0.0, True
        for x, y, m, p in zip(got, want, mag, prevs, strict=True):
            err = max(err, compare(torch, f"ama_mix_leaves {tag}", x, y, m,
                                   p.dtype))
            exact = exact and x.dtype == y.dtype and torch.equal(x, y)
        check(exact, f"ama_mix_leaves {tag}: not bitwise equal to "
              "ama_mix_leaves_math")
        vec = sum(v for la in plan for v in la.vec)
        if offset:
            check(not plan[0].vec[offset[0]],
                  f"ama_mix_leaves {tag}: the offset leaf took 16-byte loads")
        del got, want, mag
        ms = device_ms(torch, lambda: am.ama_mix_leaves(*args))
        eager = call_ms(torch, lambda: am.ama_mix_leaves(*args))
        plain = device_ms(torch, lambda: ref.ama_mix_leaves_math(*args))
        lib = None
        if set(pdts) == set(sdts) == {"float32"}:
            def addmv():
                for p, x in zip(prevs, stackeds):
                    torch.addmv(p, x.T, w, beta=a)
            lib = device_ms(torch, addmv)
        N = sum(sizes)
        nbytes = sum(2 * p.numel() * p.element_size() + x.numel()
                     * x.element_size() for p, x in zip(prevs, stackeds))
        nbytes += (K + 1) * 4
        _report(f"{tag} | {n_launch} launch(es), {vec}/{len(sizes)} 16-byte",
                ms, eager, plain, lib, nbytes, (2 * K + 1) * N, err, exact,
                record, K=K, N=N, leaves=len(sizes), dtype=pdts[0],
                rows=sdts[0], case=f"leaves {case}", launches=n_launch)
        del prevs, stackeds


def ama_mix_round_row(recs):
    """The ama_mix row of the kernel record: one legacy round of the
    paper CNN (K = 1, f32), its 8 leaves in one ama_mix_leaves call.
    Printed beside it: the same round as 8 one-leaf calls, summed."""
    row = next(r for r in recs if r["case"] == "leaves CNN"
               and r["dtype"] == "float32")
    flat = [r for r in recs if r["case"] == "leaf"
            and r["dtype"] == "torch.float32"]
    assert sorted(r["N"] for r in flat) == sorted(LEAF_SIZES)
    print(f"ama_mix, one legacy round of the CNN (K 1, f32): one call "
          f"{row['ms']:.5f} ms device, {row['call_ms']:.5f} ms eager; 8 "
          f"one-leaf calls {sum(r['ms'] for r in flat):.5f} ms device, "
          f"{sum(r['call_ms'] for r in flat):.5f} ms eager")
    return row


LLM_N = 2_583_711_744            # minitron-8b, 2 layers, full width
RWKV_N = 1_018_698_240           # rwkv6-3b, 8 layers, full width
PHI_N = 2_863_288_320            # phi3.5-moe, 2 layers, full width
ZAMBA_N = 1_119_979_648          # zamba2-1.2b, all 38 layers, full width
VLM_N = 2_918_206_464            # phi-3-vision-4.2b, 24 of 32 layers
WHISPER_N = 812_523_520          # whisper-medium, all 24 + 24 layers
LLM_K = 2                        # the pod path's cohorts
CUBLAS_ROWS = 1 << 30            # addmv rows a call, below 2**31


def addmv_ms(torch, prev, stacked, sizes, keep, coefs) -> float:
    """Device time of the library yardstick of server_mix: one
    torch.addmv, alpha * prev + stacked^T w in prev's dtype. cuBLAS's
    sizes are 32-bit, so past CUBLAS_ROWS elements the rows are cut into
    contiguous slices of CUBLAS_ROWS (copied outside the timing) and the
    slices' calls are timed together."""
    alpha = min(float(coefs[0] + coefs[1] * coefs[3]), float(coefs[2]))
    w = sizes * keep
    tot = float(w.sum())
    vec = ((1.0 - alpha) * w / max(tot, 1e-9)).to(prev.dtype)
    a_eff = alpha if tot > 0 else 1.0
    N = prev.numel()
    if N <= CUBLAS_ROWS:
        return device_ms(torch, lambda: torch.addmv(prev, stacked.T, vec,
                                                    beta=a_eff),
                         reps=2, replays=5)
    parts = [(prev[a:a + CUBLAS_ROWS], stacked[:, a:a + CUBLAS_ROWS]
              .contiguous()) for a in range(0, N, CUBLAS_ROWS)]

    def sliced():
        for p, m in parts:
            torch.addmv(p, m.T, vec, beta=a_eff)
    ms = device_ms(torch, sliced, reps=2, replays=5)
    del parts
    return ms


def check_server_mix_llm(torch, sp, ref, record, N, label):
    """server_mix at an LLM path's size: N bf16 (past 2**31 for
    minitron-8b, so every index is 64-bit), K = 2, on the 16-byte vector
    kernel, bitwise against the plain version; the plain version's time is an eager call (its f32
    temporaries do not fit a graph of several calls); the library
    yardstick is addmv in bf16 (``addmv_ms``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    K = LLM_K
    prev = torch.randn(N, device=dev, generator=g, dtype=torch.bfloat16)
    stacked = torch.randn(K, N, device=dev, generator=g, dtype=torch.bfloat16)
    sizes = torch.ones(K, device=dev)
    keep = torch.tensor([1.0, 0.0], device=dev)
    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 7.0], device=dev)
    args = (prev, stacked, sizes, keep, coefs)
    got, design = mix_design(sp, lambda: sp.server_mix_flat(*args))
    check(design == "vector", f"server_mix at N = {N:,} bf16 took the "
          f"{design} kernel")
    want = ref.server_mix_math(*args)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    check(exact, f"server_mix at N = {N:,} bf16: not bitwise equal to the "
          "plain version")
    del got, want
    ms = device_ms(torch, lambda: sp.server_mix_flat(*args), reps=2,
                   replays=5)
    eager = call_ms(torch, lambda: sp.server_mix_flat(*args), iters=3)
    plain = call_ms(torch, lambda: ref.server_mix_math(*args), iters=2)
    torch.cuda.empty_cache()
    lib = addmv_ms(torch, *args)
    nbytes = (K + 2) * N * 2 + 2 * K * 4 + 16
    _report(f"K={K} N={N:,} bfloat16 {label:9s} {design}", ms, eager, plain,
            lib, nbytes, (2 * K + 1) * N, 0.0, exact, record, K=K, N=N,
            dtype="torch.bfloat16", case=label, design=design)
    del prev, stacked, args
    torch.cuda.empty_cache()


#: (dtype, hd, causal, window, B, S, H, Hkv): minitron's attention with kv
#: head-repeated (Hkv = H, the TPU kernel's contract) and as the LLM path
#: calls it (its 8 kv heads), then the variations phase 3 holds the
#: kernels to: hd 64 / 96, f32 (the CUDA-core kernels, GQA included), a
#: window, non-causal, one tile, B*H = 1, GQA at n_rep 2, and ragged S =
#: 100 (one partial tile) in bf16
FLASH_MAIN = ("bfloat16", 128, True, 0, 2, 2048, 32, 32)
FLASH_GQA = ("bfloat16", 128, True, 0, 2, 2048, 32, 8)
#: mixtral-8x22b's attention on its pod path: 48 heads over 8 (n_rep 6),
#: its window of 4096 (wider than S, so every causal pair is visible)
FLASH_MIXTRAL = ("bfloat16", 128, True, 4096, 2, 2048, 48, 8)
FLASH_TIMED = (FLASH_MAIN, FLASH_GQA, FLASH_MIXTRAL)
#: slice 20: the vlm's decoder (phi-3-vision-4.2b: 576 patches + 2,048
#: tokens = 2,624 rows, 32 heads of 96, MHA, 2 cohorts), whisper-medium's
#: encoder (1,500 frames, non-causal, 16 heads of 64) and its decoder's
#: cross-attention (2,048 tokens against the 1,500 frames: a 9th field,
#: Skv, when it differs from S)
FLASH_VLM = ("bfloat16", 96, True, 0, 2, 2624, 32, 32)
FLASH_WHISPER_ENC = ("bfloat16", 64, False, 0, 2, 1500, 16, 16)
FLASH_WHISPER_CROSS = ("bfloat16", 64, False, 0, 2, 2048, 16, 16, 1500)
FLASH_TIMED += (FLASH_VLM, FLASH_WHISPER_ENC, FLASH_WHISPER_CROSS)
FLASH_CASES = [FLASH_MAIN, FLASH_GQA, FLASH_MIXTRAL,
               ("bfloat16", 64, True, 0, 2, 2048, 32, 32),
               ("bfloat16", 96, True, 0, 2, 2048, 32, 32),
               ("float32", 128, True, 0, 2, 2048, 32, 32),
               ("bfloat16", 128, True, 256, 2, 2048, 32, 32),
               ("bfloat16", 128, False, 0, 2, 2048, 32, 32),
               ("bfloat16", 128, True, 0, 2, 128, 32, 32),
               ("bfloat16", 128, True, 0, 1, 2048, 1, 1),
               ("bfloat16", 64, True, 0, 2, 2048, 32, 16),
               ("float32", 128, True, 0, 2, 512, 8, 2),
               ("bfloat16", 128, True, 0, 1, 100, 4, 2),
               ("bfloat16", 64, False, 32, 1, 100, 3, 1),
               FLASH_VLM, FLASH_WHISPER_ENC, FLASH_WHISPER_CROSS,
               # whisper's decoder self-attention, a query row against
               # the frames, small ragged lengths on both designs
               ("bfloat16", 64, True, 0, 2, 2048, 16, 16),
               ("bfloat16", 64, False, 0, 2, 1, 16, 16, 1500),
               ("float32", 64, False, 0, 1, 1500, 4, 4),
               ("float32", 64, False, 0, 1, 129, 4, 4, 1500),
               ("bfloat16", 64, True, 0, 1, 129, 4, 2),
               ("float32", 64, True, 0, 1, 129, 4, 2),
               ("bfloat16", 96, True, 0, 1, 200, 4, 4),
               ("float32", 96, True, 0, 1, 200, 4, 4)]
#: the kernel design each input dtype must take (flash_design_counts)
FLASH_DESIGN = {"bfloat16": "wgmma", "float32": "cuda_cores"}


def flash_case(case) -> tuple:
    """(dtype, hd, causal, window, B, Sq, Skv, H, Hkv) of a FLASH_CASES
    entry (Skv = S unless a 9th field gives it)."""
    dtn, hd, causal, window, B, S, H, Hkv, *kv = case
    return dtn, hd, causal, window, B, S, kv[0] if kv else S, H, Hkv


def visible_pairs(S: int, causal: bool, window: int,
                  Skv: int | None = None) -> int:
    """Query-key pairs the mask lets through (the work this input needs);
    every pair of S queries and Skv keys when they differ
    (cross-attention)."""
    if Skv is not None and Skv != S:
        return S * Skv
    total = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_rule(torch, name, got, want32, plain) -> float:
    """FlashAttention's own rule: in bf16 the kernel's max error against
    the plain version run in f32 on the same inputs is at most twice the
    plain version's own error when run in bf16, with a floor of 1e-3 x
    max|want|; in f32, atol 1e-5 + rtol 1e-5 against the plain version.
    Returns the kernel's max error."""
    err = float((got.float() - want32).abs().max())
    if got.dtype == torch.float32:
        ok = torch.allclose(got, want32, rtol=1e-5, atol=1e-5)
        limit = "atol 1e-5 + rtol 1e-5"
    else:
        own = float((plain.float() - want32).abs().max())
        bound = max(2 * own, 1e-3 * float(want32.abs().max()))
        ok = err <= bound
        limit = f"{bound:.3e} (2 x the plain bf16 error {own:.3e})"
    check(ok, f"{name}: max error {err:.3e} beyond {limit}")
    return err


def check_flash(torch, fa, ref, record):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkdv against their plain
    versions on the same inputs in every FLASH_CASES case, each dtype on
    its own design (bf16 on the tensor cores, f32 on the CUDA cores:
    the C entries' per-design launch counts); device times at minitron's
    shape, kv head-repeated and GQA, beside the compute bound, the plain
    version and scaled_dot_product_attention (forward; backward through
    autograd), a yardstick the port never calls."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    F = torch.nn.functional
    print("flash attention: dtype, hd, causal, window, B, S (or Sq x Skv), "
          "H / Hkv | max error of fwd / dq / dk / dv against the plain "
          "version in f32 (the plain version's own bf16 error)")
    for case in FLASH_CASES:
        dtn, hd, causal, window, B, S, Skv, H, Hkv = flash_case(case)
        dt = getattr(torch, dtn)
        q, dout = (torch.randn(B, S, H, hd, device=dev, generator=g).to(dt)
                   for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, hd, device=dev, generator=g).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        tag = (f"{dtn} hd={hd} causal={causal} window={window} B={B} "
               f"S={S if Skv == S else f'{S}x{Skv}'} H={H}/{Hkv}")
        before = fa.design_launches()
        up = [x.float() for x in (dout, q, k, v)]
        out32, _ = ref.flash_attention_ref(*up[1:], **kw)
        out_lo, lse_lo = ref.flash_attention_ref(q, k, v, **kw)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        errs = [flash_rule(torch, f"flash_fwd {tag}", out, out32, out_lo)]
        own = float((out_lo.float() - out32).abs().max())
        check(torch.allclose(lse, lse_lo, rtol=1e-5, atol=1e-5),
              f"flash_fwd {tag}: lse differs by "
              f"{float((lse - lse_lo).abs().max()):.3e}")
        del out32
        dq32, _ = ref.flash_bwd_dq_ref(*up, out_lo.float(), lse_lo, **kw)
        dq_lo, d_lo = ref.flash_bwd_dq_ref(dout, q, k, v, out_lo, lse_lo,
                                           **kw)
        dq, delta = fa.flash_bwd_dq(dout, q, k, v, out_lo, lse_lo, **kw)
        torch.cuda.synchronize()
        errs.append(flash_rule(torch, f"flash_bwd_dq {tag}", dq, dq32,
                               dq_lo))
        check(torch.allclose(delta, d_lo, rtol=1e-5, atol=1e-5),
              f"flash_bwd_dq {tag}: D differs by "
              f"{float((delta - d_lo).abs().max()):.3e}")
        del dq32, dq_lo
        dk32, dv32 = ref.flash_bwd_dkdv_ref(*up, lse_lo, d_lo, **kw)
        dk_lo, dv_lo = ref.flash_bwd_dkdv_ref(dout, q, k, v, lse_lo, d_lo,
                                              **kw)
        dk, dv = fa.flash_bwd_dkdv(dout, q, k, v, lse_lo, d_lo, **kw)
        torch.cuda.synchronize()
        errs.append(flash_rule(torch, f"flash_bwd_dkdv dk {tag}", dk, dk32,
                               dk_lo))
        errs.append(flash_rule(torch, f"flash_bwd_dkdv dv {tag}", dv, dv32,
                               dv_lo))
        after = fa.design_launches()
        want = FLASH_DESIGN[dtn]
        for name in fa.KERNELS:
            moved = {d: after[name][d] - before[name][d] for d in fa.DESIGNS}
            check(moved == {d: int(d == want) for d in fa.DESIGNS},
                  f"{name} {tag}: launches by design {moved}, expected one "
                  f"on {want}")
        print(f"  {tag} | {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} / "
              f"{errs[3]:.3e} (fwd plain bf16 {own:.3e}) | {want}")
        rec = dict(case=case, err_fwd=errs[0], err_dq=errs[1],
                   err_dkdv=max(errs[2:]))
        if case in FLASH_TIMED:
            rec.update(time_flash(torch, fa, ref, F, case, q, k, v, dout,
                                  out_lo, lse_lo, d_lo))
        record.append(rec)
        del q, k, v, dout, up, out, lse, out_lo, lse_lo, dq, delta, d_lo
        del dk32, dv32, dk_lo, dv_lo, dk, dv
        torch.cuda.empty_cache()
    x = torch.zeros(1, 200, 2, 128, device=dev, dtype=torch.bfloat16)
    for kw in (dict(causal=True), dict(causal=False, window=64)):
        for fn in (fa.flash_attention, fa.flash_fwd):
            try:
                fn(x, x[:, :130], x[:, :130], **kw)
            except ValueError:
                continue
            fail(f"{fn.__name__} took q of 200 rows against k, v of 130 "
                 f"with {kw}")
    print("flash attention: any S goes (the 129 / 200 / 1,500 / 2,624 "
          "cases above); q of 200 rows against k, v of 130 refused with a "
          "causal mask or a window (cross-attention takes neither)")


def time_flash(torch, fa, ref, F, case, q, k, v, dout, out, lse, delta):
    """Device times of the three kernels, their plain versions and SDPA at
    one shape, with each kernel's bound (the function's flops at the peak
    rate of the input type, against its bytes: q, out, dO, dq at H heads,
    k, v, dk, dv at Hkv heads)."""
    dtn, hd, causal, window, B, S, Skv, H, Hkv = flash_case(case)
    kw = dict(causal=causal, window=window)
    rate = BF16_FLOPS_PER_S if dtn == "bfloat16" else F32_FLOPS_PER_S
    s = q.element_size()
    E, Ekv, rows = B * S * H * hd, B * Skv * Hkv * hd, B * H * S * 4
    n = B * H * visible_pairs(S, causal, window, Skv) * hd
    work = {"flash_fwd": ((2 * E + 2 * Ekv) * s + rows, 4 * n),
            "flash_bwd_dq": ((4 * E + 2 * Ekv) * s + 2 * rows,
                             6 * n + 2 * E),
            "flash_bwd_dkdv": ((2 * E + 4 * Ekv) * s + 2 * rows, 8 * n)}
    kernels = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(dout, q, k, v, out, lse,
                                                **kw),
        "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(dout, q, k, v, lse,
                                                    delta, **kw)}
    plains = {
        "flash_fwd": lambda: ref.flash_attention_ref(q, k, v, **kw),
        "flash_bwd_dq": lambda: ref.flash_bwd_dq_ref(dout, q, k, v, out,
                                                     lse, **kw),
        "flash_bwd_dkdv": lambda: ref.flash_bwd_dkdv_ref(dout, q, k, v,
                                                         lse, delta, **kw)}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = dict(enable_gqa=True) if Hkv != H else {}
    # SDPA computes the same function where the window lets every causal
    # pair through (window 0 or wider than S)
    check(not window or window >= S, f"time_flash: no library call for a "
          f"window of {window} at S {S}")
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, **gqa), reps=10, replays=10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, **gqa)
    do = dout.transpose(1, 2)
    lib_bwd = call_ms(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), do, retain_graph=True), iters=10)
    out_rec = {"library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd}
    print(f"flash attention at {dtn} hd={hd} causal={causal} "
          f"window={window} B={B} S={S}{f' Skv={Skv}' * (Skv != S)} H={H} "
          f"Hkv={Hkv}: kernel device ms | bound ms (by) | plain device ms | "
          "library")
    for name, fn in kernels.items():
        ms = device_ms(torch, fn, reps=3, replays=5)
        plain = device_ms(torch, plains[name], reps=1, replays=3)
        nbytes, flops = work[name]
        bnd, by = bound_ms(nbytes, flops, rate)
        lib = lib_fwd if name == "flash_fwd" else None
        print(f"  {name:15s} | {ms:9.4f} ms | {bnd:.4f} ({by}, "
              f"{flops / 1e9:.1f} GFLOP) | plain {plain:9.4f} | lib "
              f"{'-' if lib is None else f'{lib:.4f}'}")
        out_rec[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             nbytes=nbytes, flops=flops, bound_ms=bnd,
                             bound_by=by)
        torch.cuda.empty_cache()
    bwd = out_rec["flash_bwd_dq"]["ms"] + out_rec["flash_bwd_dkdv"]["ms"]
    print(f"  backward (dq + dkdv) {bwd:.4f} ms | SDPA{' (GQA)' * bool(gqa)} "
          f"backward through autograd, eager call {lib_bwd:.4f} ms | SDPA "
          f"forward {lib_fwd:.4f} ms")
    return out_rec


#: (B, S, H, hd, decay, label): the rwkv6 path's shape first (B 2 = 2
#: cohorts x 1 sequence, S 2048, H 40, hd 64, decays over the model's
#: whole range exp(-exp([-8, 4])) = [2.3e-24, 0.99966]), then the
#: variations phase 3 holds the kernels to: B*H = 1, the Pallas kernel's
#: test shapes (S 64 and 96 at chunk 32, hd 16), a ragged last segment
#: at hd 32, decays all near 0 and all near 1, a ragged last segment
#: after 127 whole ones at the main width, exactly one segment at B*H 80
RWKV_MAIN = (2, 2048, 40, 64, "model", "main")
RWKV_DECODE = (4, 1, 40, 64, "model", "decode, S = 1")  # the serving path
RWKV_CASES = [RWKV_MAIN,
              (1, 2048, 1, 64, "model", "B*H = 1"),
              (2, 64, 2, 16, "model", "S 64, chunk 32, hd 16"),
              (2, 96, 2, 64, "model", "S 96, chunk 32"),
              (1, 100, 3, 32, "model", "ragged, hd 32"),
              (2, 256, 4, 64, "near 0", "decay ~2e-24"),
              (2, 2048, 4, 64, "near 1", "decay 0.99966"),
              (2, 2047, 40, 64, "model", "S 2047, ragged"),
              (2, 16, 40, 64, "model", "one segment"),
              RWKV_DECODE]


def rwkv6_inputs(torch, g, B, S, H, hd, decay):
    dev = torch.device("cuda")
    r, k, v, dy = (0.5 * torch.randn(B, S, H, hd, device=dev, generator=g)
                   for _ in range(4))
    z = torch.rand(B, S, H, hd, device=dev, generator=g)
    if decay == "model":
        w = torch.exp(-torch.exp(12.0 * z - 8.0))
    elif decay == "near 0":
        w = torch.exp(-torch.exp(3.9 + 0.1 * z))      # 2.3e-24 .. 1e-21
    else:
        w = torch.full_like(z, math.exp(-math.exp(-8.0)))
    u = 0.1 * torch.randn(B, H, hd, device=dev, generator=g)  # per row
    s0, ds = (0.1 * torch.randn(B, H, hd, hd, device=dev, generator=g)
              for _ in range(2))
    return r, k, v, w, u, s0, dy, ds


def check_rwkv6(torch, rs, ref, record):
    """rwkv6_fwd and rwkv6_bwd against their plain versions on the same
    inputs (s0, d(s_final) and u non-zero) in every RWKV_CASES case:
    every output and gradient within 1e-5 x (1 + max |plain|); the
    entry's contract (S a multiple of min(chunk, S)) at S = 64 and 96
    with chunk 32; device times at the path's shape beside the bound and
    the plain version (no single library call computes the recurrence)."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(8)
    names = ("y", "s_final", "states", "dr", "dk", "dv", "dw", "du", "ds0")
    print("rwkv6: B, S, H, hd, case | max |kernel - plain| / (1 + max "
          "|plain|) over y, s_final, states / dr, dk, dv, dw, du, ds0 "
          "(limit 1e-5) | max |kernel - plain| fwd / bwd")
    for case in RWKV_CASES:
        B, S, H, hd, decay, label = case
        r, k, v, w, u, s0, dy, ds = rwkv6_inputs(torch, g, B, S, H, hd,
                                                 decay)
        got = rs.rwkv6_fwd(r, k, v, w, u, s0)
        want = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
        got += rs.rwkv6_bwd(dy, ds, r, k, v, w, u, want[2])
        want += ref.rwkv6_scan_bwd_ref(dy, ds, r, k, v, w, u, want[2])
        torch.cuda.synchronize()
        errs, abss = [], []
        for name, a, b in zip(names, got, want, strict=True):
            check(a.shape == b.shape, f"rwkv6 {label}: {name} shape")
            abss.append(float((a - b).abs().max()))
            e = abss[-1] / (1.0 + float(b.abs().max()))
            check(e <= 1e-5, f"rwkv6 {label} (B={B} S={S} H={H} hd={hd}): "
                  f"{name} differs by {e:.3e} x (1 + max |plain|)")
            errs.append(e)
        if S in (64, 96):                   # the Pallas tests' chunk 32
            y, sf = rs.rwkv6_scan(r, k, v, w, u[0], s0, chunk=32)
            y1, sf1, _ = rs.rwkv6_fwd(r, k, v, w,
                                      u[0].expand(B, H, hd).contiguous(), s0)
            check(torch.equal(y, y1) and torch.equal(sf, sf1),
                  f"rwkv6_scan {label}: differs from rwkv6_fwd")
        print(f"  B={B} S={S:5d} H={H:2d} hd={hd} {label:22s} | "
              f"{max(errs[:3]):.2e} / {max(errs[3:]):.2e} | "
              f"{max(abss[:3]):.2e} / {max(abss[3:]):.2e}")
        rec = dict(case=case, err_fwd=max(abss[:3]), err_bwd=max(abss[3:]))
        if case in (RWKV_MAIN, RWKV_DECODE):
            rec.update(time_rwkv6(torch, rs, ref, case, r, k, v, w, u, s0,
                                  dy, ds, want[2]))
        record.append(rec)
        del r, k, v, w, u, s0, dy, ds, got, want
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    x = torch.zeros(1, 200, 2, 64, device=dev)
    try:
        rs.rwkv6_scan(x, x, x, x, torch.zeros(2, 64, device=dev),
                      torch.zeros(1, 2, 64, 64, device=dev))
    except ValueError:
        print("rwkv6: S = 200 refused at chunk 128 (S must be a multiple of "
              "min(chunk, S))")
    else:
        fail("rwkv6_scan took S=200, which the TPU kernel refuses")


def time_rwkv6(torch, rs, ref, case, r, k, v, w, u, s0, dy, ds, states):
    """Device times of both kernels and their plain versions at one
    shape, with each kernel's bound: the bytes and flops of the function
    it computes, not of its design (the states the forward saves every
    RWKV6_CKPT steps and the backward's recomputation of them are left
    out). Bytes: each input read once, each output written once; forward
    r, k, v, w, u, s0 -> y, s_final; backward dy, d(s_final), r, k, v, w,
    u, s0 -> dr, dk, dv, dw, du, ds0. Flops a step per (b, h) at the f32
    rate: forward 5 hd^2 + 5 hd (r . S, w * S + k^T v, and the bonus as
    (sum_i r_i u_i k_i) v); backward 11 hd^2 + 16 hd (dr, dk, dv, dw by
    matrix-vector products, the adjoint's update, the bonus terms).
    Beside it, each design's own bound, by the bytes its two passes move
    (csrc/rwkv6_scan.cu): forward, pass 1 k, v, w, s0 -> states, s_final
    and pass 2 r, k, v, w, u, states -> y; backward, pass 1 r, k, v, w,
    dy, d(s_final) -> the adjoint at every boundary, du, ds0 and pass 2
    r, k, v, w, dy, u, states, the adjoints -> dr, dk, dv, dw. Each call
    runs exactly two device kernels (a profiler trace of one call)."""
    B, S, H, hd = case[:4]
    E, BH, nu = B * S * H * hd, B * H, u.numel()
    mat, steps = BH * hd * hd, BH * S
    ns = states.numel()               # B H ceil(S / RWKV6_CKPT) hd^2
    work = {"rwkv6_fwd": (4 * (5 * E + nu + 2 * mat),
                          steps * (5 * hd * hd + 5 * hd)),
            "rwkv6_bwd": (4 * (9 * E + 2 * nu + 3 * mat),
                          steps * (11 * hd * hd + 16 * hd))}
    design_bytes = {"rwkv6_fwd": 4 * (3 * E + 2 * mat + ns
                                      + 4 * E + nu + ns + E),
                    "rwkv6_bwd": 4 * (5 * E + mat + ns + nu + mat
                                      + 5 * E + nu + 2 * ns + 4 * E)}
    kernels = {"rwkv6_fwd": lambda: rs.rwkv6_fwd(r, k, v, w, u, s0),
               "rwkv6_bwd": lambda: rs.rwkv6_bwd(dy, ds, r, k, v, w, u,
                                                 states)}
    plains = {"rwkv6_fwd": lambda: ref.rwkv6_scan_ref(r, k, v, w, u, s0),
              "rwkv6_bwd": lambda: ref.rwkv6_scan_bwd_ref(dy, ds, r, k, v,
                                                          w, u, states)}
    print(f"rwkv6 at B={B} S={S} H={H} hd={hd} f32: kernel device ms | "
          "bound ms (by) of the function | the design's bound (its bytes) "
          "| plain device ms | library: none (no single call computes the "
          "recurrence)")
    out = {}
    for name, fn in kernels.items():
        launched = device_kernels(torch, fn, name)
        passes = sorted(m.group(0) for n in launched
                        if (m := re.search(r"\w+_kernel", n)))
        check(len(launched) == 2 and passes == [f"{name}_scan_kernel",
                                                f"{name}_seg_kernel"],
              f"{name}: one call ran {launched}, expected its two passes")
        ms = device_ms(torch, fn, reps=5, replays=10)
        plain = device_ms(torch, plains[name], reps=1, replays=3)
        nbytes, flops = work[name]
        bnd, by = bound_ms(nbytes, flops)
        dbnd = design_bytes[name] / HBM_BYTES_PER_S * 1e3
        print(f"  {name:10s} | {ms:9.4f} ms | {bnd:.4f} ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) | "
              f"{dbnd:.4f} ({design_bytes[name] / 1e6:.1f} MB) | plain "
              f"{plain:9.4f} | passes {passes}")
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                         nbytes=nbytes, flops=flops, bound_ms=bnd,
                         bound_by=by, design_bound_ms=dbnd)
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- mamba2 (A1) -----

#: (B, S, H, N, decay, h0, label): the pod path's shape (2 cohorts x 1 x
#: 2048 tokens, zamba2's 64 heads of 64 and state 64), the reduced
#: config's widths (8 heads, state 16), a ragged S, the serving path's
#: decode step, a zero h0, decays near 0 and near 1, exact zeros in a
#: (a fifth of the steps) and a = 1 throughout
MAMBA_MAIN = (2, 2048, 64, 64, "model", True, "pod shape")
MAMBA_DECODE = (4, 1, 64, 64, "model", True, "decode, S = 1")
MAMBA_CASES = [MAMBA_MAIN,
               (2, 2048, 8, 16, "model", True, "reduced widths"),
               (2, 100, 64, 64, "model", True, "S 100, ragged"),
               MAMBA_DECODE,
               (2, 256, 64, 64, "model", False, "h0 = 0"),
               (2, 256, 4, 64, "near 0", True, "decay ~1e-30"),
               (2, 2048, 4, 64, "near 1", True, "decay 0.99990"),
               (2, 300, 8, 64, "zeros", True, "exact zeros in a"),
               (2, 2048, 4, 64, "one", True, "a = 1")]


def mamba2_inputs(torch, g, B, S, H, N, decay, h0_on):
    """The recurrence's operands as the model makes them: a = exp(dt_s A)
    with dt_s = softplus(dt), A = -exp(A_log), xdt = x dt_s, B and C off
    the conv; near 0 and near 1 the decay is drawn there, "zeros" sets a
    fifth of the model's decays to exactly 0 and "one" takes a = 1."""
    dev = torch.device("cuda")
    dt_s = torch.nn.functional.softplus(
        torch.randn(B, S, H, device=dev, generator=g))
    if decay in ("model", "zeros"):
        A = -torch.exp(0.5 * torch.randn(H, device=dev, generator=g))
        a = torch.exp(dt_s * A)
        if decay == "zeros":
            a = a.masked_fill(
                torch.rand(B, S, H, device=dev, generator=g) < 0.2, 0.0)
    elif decay == "near 0":
        a = 1e-30 * torch.rand(B, S, H, device=dev, generator=g)
    elif decay == "one":
        a = torch.ones(B, S, H, device=dev)
    else:
        a = torch.full((B, S, H), 0.9999, device=dev)
    x = torch.randn(B, S, H, 64, device=dev, generator=g)
    xdt = x * dt_s[..., None]
    Bm, Cm = (torch.randn(B, S, N, device=dev, generator=g)
              for _ in range(2))
    h0 = 0.3 * torch.randn(B, H, 64, N, device=dev, generator=g)
    if not h0_on:
        h0.zero_()
    dy = 0.5 * torch.randn(B, S, H, 64, device=dev, generator=g)
    dh = 0.3 * torch.randn(B, H, 64, N, device=dev, generator=g)
    return a, xdt, Bm, Cm, h0, dy, dh


def check_mamba2(torch, ms, ref, record):
    """mamba2_fwd and mamba2_bwd against their plain versions on the same
    inputs in every MAMBA_CASES case: every output and gradient, h_final
    and the states among them, within 1e-5 x (1 + max |plain|) (the chunk
    form sums a chunk boundary's state in another order than the per-step
    recurrence); the backward on the kernel's own states (the pod path's
    pairing) within the same rule of the plain backward on the plain
    states; a second call of each the same bits; device times at the pod
    shape and the decode step beside the bounds and the plain version (no
    single library call computes the recurrence)."""
    traced = mamba2_kernels_fresh()
    g = torch.Generator(device=torch.device("cuda")).manual_seed(28)
    names = ("y", "h_final", "states", "da", "dxdt", "dB", "dC", "dh0")
    print("mamba2: B, S, H, N, case | max |kernel - plain| / (1 + max "
          "|plain|) over y, h_final, states / da, dxdt, dB, dC, dh0 / the "
          "backward on the kernel's states (limit 1e-5) | max |kernel - "
          "plain| fwd / bwd | two calls bitwise")
    for case in MAMBA_CASES:
        B, S, H, N, decay, h0_on, label = case
        a, xdt, Bm, Cm, h0, dy, dh = mamba2_inputs(torch, g, B, S, H, N,
                                                   decay, h0_on)
        got = ms.mamba2_fwd(a, xdt, Bm, Cm, h0)
        want = ref.mamba2_scan_ref(a, xdt, Bm, Cm, h0)
        got += ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm, want[2])
        want += ref.mamba2_scan_bwd_ref(dy, dh, a, xdt, Bm, Cm, want[2])
        own = ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm, got[2])
        torch.cuda.synchronize()
        errs, abss = [], []
        for name, u, v in zip(names + names[3:], got + own, want + want[3:],
                              strict=True):
            check(u.shape == v.shape, f"mamba2 {label}: {name} shape")
            abss.append(float((u - v).abs().max()))
            e = abss[-1] / (1.0 + float(v.abs().max()))
            check(e <= 1e-5, f"mamba2 {label} (B={B} S={S} H={H} N={N}): "
                  f"{name} differs by {e:.3e} x (1 + max |plain|)")
            errs.append(e)
        again = (*ms.mamba2_fwd(a, xdt, Bm, Cm, h0),
                 *ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm, want[2]))
        same = all(torch.equal(u, v) for u, v in zip(again, got,
                                                     strict=True))
        check(same, f"mamba2 {label}: two calls differ")
        print(f"  B={B} S={S:5d} H={H:2d} N={N} {label:16s} | "
              f"{max(errs[:3]):.2e} / {max(errs[3:8]):.2e} / "
              f"{max(errs[8:]):.2e} | {max(abss[:3]):.2e} / "
              f"{max(abss[3:]):.2e} | {same}")
        rec = dict(case=case, err_fwd=max(abss[:3]), err_bwd=max(abss[3:]),
                   rel_fwd=max(errs[:3]), rel_bwd=max(errs[3:]))
        if case in (MAMBA_MAIN, MAMBA_DECODE):
            rec.update(time_mamba2(torch, ms, ref, case, a, xdt, Bm, Cm, h0,
                                   dy, dh, want[2], traced))
        record.append(rec)
        del a, xdt, Bm, Cm, h0, dy, dh, got, want, own, again
        torch.cuda.empty_cache()


def mamba2_traced(torch, ms) -> dict:
    """{wrapper: the device kernels one call of it runs} for mamba2_fwd and
    mamba2_bwd at the pod shape (MAMBA_MAIN), from profiler traces of
    this process (``device_kernels``)."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(28)
    B, S, H, N, decay, h0_on, _ = MAMBA_MAIN
    a, xdt, Bm, Cm, h0, dy, dh = mamba2_inputs(torch, g, B, S, H, N, decay,
                                               h0_on)
    states = ms.mamba2_fwd(a, xdt, Bm, Cm, h0)[2]
    return {"mamba2_fwd": device_kernels(
                torch, lambda: ms.mamba2_fwd(a, xdt, Bm, Cm, h0),
                "mamba2_fwd"),
            "mamba2_bwd": device_kernels(
                torch, lambda: ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm, states),
                "mamba2_bwd")}


def mamba2_kernels_fresh() -> dict:
    """``mamba2_traced`` in a process of its own, whose profiler sessions
    are the first it opens and follow no CUDA graph: in this process,
    after phase 3's other checks, three sessions around one mamba2 call
    in a row have traced no device activity. Prints that process's
    ``trace_summary`` and returns its result."""
    code = ("import json, sys; sys.path[:0] = ['src', '.']; import torch; "
            "import chip_smoke as cs; "
            "from repro_torch.kernels import mamba2_scan as ms; "
            "got = cs.mamba2_traced(torch, ms); "
            "print('  fresh process: ' + cs.trace_summary()); "
            "print('MAMBA2-KERNELS ' + json.dumps(got))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    out = proc.stdout.splitlines()
    print("\n".join(x for x in out if not x.startswith("MAMBA2-KERNELS ")))
    check(proc.returncode == 0, "mamba2: the traces of one call failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(next(x for x in out if x.startswith(
        "MAMBA2-KERNELS "))[len("MAMBA2-KERNELS "):])


def mamba2_design_flops(B, S, H, N, P=64, L=64):
    """The products the chunk form runs (csrc/mamba2_scan.cu), each
    counted whole (2 m n k) whatever its triangle: forward C B^T once a
    chunk and, per chunk and head, S_c = X^T diag(E) B, C h_c^T and (Lm o
    C B^T) X; backward C B^T and, per chunk and head, U_c, dY X^T, dY h_c,
    X R, W B, W^T C, B R^T, (Lm o C B^T)^T dY and (dY X^T o C B^T) L'^T.
    Below S = L the forward runs the per-step form: 5 P N flops a step per
    (b, h) on the CUDA cores."""
    NC = -(-S // L)
    unit = 2 * L
    fwd = B * NC * (unit * L * N + H * unit * (P * N + N * P + L * P))
    bwd = B * NC * (unit * L * N + H * unit * (
        P * N + L * P + P * N + P * N + L * N + L * N + N * P + L * P
        + L * L))
    return {"mamba2_fwd": fwd if S >= L else None, "mamba2_bwd": bwd}


def time_mamba2(torch, ms, ref, case, a, xdt, Bm, Cm, h0, dy, dh, states,
                traced):
    """Device times of both kernels and their plain versions at one
    shape, with two bounds for each. Both take the bytes the function
    must move (the states the forward saves and the design's scratch
    left out): each input read once, each output written once; forward
    a, xdt, B, C, h0 -> y, h_final; backward dy, d(h_final), a, xdt, B,
    C, h0 -> da, dxdt, dB, dC, dh0. ``bound_ms``, at the rate of the
    units the design runs on: the chunk form's products
    (``mamba2_design_flops``) in three tf32 tensor-core passes at 495
    TFLOP/s, or the bytes, whichever is larger (below S = 64 the
    forward's per-step form runs on the CUDA cores: its f32 bound).
    ``f32_bound_ms``, the per-step recurrence's flops at the f32 rate or
    the bytes: flops a step per (b, h), forward 5 P N (a h + x B, y = h
    C), backward 14 P N (h_t again, G += dy C, G = a G, the four products
    dC, dxdt, dB, da); the chunk form runs below it, so it is no lower
    bound there and is printed for comparison with PR 28's rows. The
    forward runs three device kernels a call at the pod shape, the
    backward four: ``traced``, the kernels one call of each runs there
    (``mamba2_kernels_fresh``)."""
    B, S, H, N = case[:4]
    P = 64
    E, BS, mat = B * S * H * P, B * S, B * H * P * N
    steps = B * S * H
    work = {"mamba2_fwd": (4 * (BS * H + E + 2 * BS * N + mat + E + mat),
                           steps * 5 * P * N),
            "mamba2_bwd": (4 * (2 * E + mat + BS * H + 2 * BS * N + mat
                                + BS * H + E + 2 * BS * N + mat),
                           steps * 14 * P * N)}
    design = mamba2_design_flops(B, S, H, N, P)
    kernels = {"mamba2_fwd": lambda: ms.mamba2_fwd(a, xdt, Bm, Cm, h0),
               "mamba2_bwd": lambda: ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm,
                                                   states)}
    plains = {"mamba2_fwd": lambda: ref.mamba2_scan_ref(a, xdt, Bm, Cm, h0),
              "mamba2_bwd": lambda: ref.mamba2_scan_bwd_ref(
                  dy, dh, a, xdt, Bm, Cm, states)}
    passes = {"mamba2_fwd": ["mamba2_out_kernel", "mamba2_pass_kernel",
                             "mamba2_state_kernel"],
              "mamba2_bwd": ["mamba2_bwd_heads_kernel", "mamba2_grad_kernel",
                             "mamba2_pass_kernel", "mamba2_state_kernel"]}
    print(f"mamba2 at B={B} S={S} H={H} P={P} N={N} f32: kernel device ms | "
          "bound ms (by; the design's products, 3 x tf32 at 495 TFLOP/s) | "
          "f32-rate bound ms (by; the per-step flops at 67 TFLOP/s) | "
          "plain device ms | library: none (no single call computes the "
          "recurrence)")
    out = {}
    for name, fn in kernels.items():
        got = "not traced"
        if case == MAMBA_MAIN:
            launched = traced[name]
            got = sorted(m.group(0) for n in launched
                         if (m := re.search(r"mamba2_\w+_kernel", n)))
            check(len(launched) == len(passes[name])
                  and got == passes[name], f"{name}: one call ran "
                  f"{launched}, expected {passes[name]}")
        ms_ = device_ms(torch, fn, reps=5, replays=10)
        plain = slow_ms(torch, plains[name])
        nbytes, f32_flops = work[name]
        f32_bnd, f32_by = bound_ms(nbytes, f32_flops)
        if design[name] is None:
            bnd, by, flops = f32_bnd, f32_by, f32_flops
        else:
            flops = 3 * design[name]
            bnd, by = bound_ms(nbytes, flops, TF32_FLOPS_PER_S)
        print(f"  {name:10s} | {ms_:9.4f} ms | {bnd:.4f} ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) | "
              f"{f32_bnd:.4f} ({f32_by}; {f32_flops / 1e9:.2f} GFLOP) | "
              f"plain {plain:9.4f} | kernels {got}")
        out[name] = dict(ms=ms_, plain_ms=plain, library_ms=None,
                         nbytes=nbytes, flops=flops, bound_ms=bnd,
                         bound_by=by, f32_flops=f32_flops,
                         f32_bound_ms=f32_bnd, f32_bound_by=f32_by)
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- serving attention -----

#: minitron-8b's serving shape (CONFIG_SWA): 32 query heads over 8 kv
#: heads of 128, a ring of 4096 slots, paged in blocks of 16
SERVE_H, SERVE_KH, SERVE_HD, SERVE_L, SERVE_BS = 32, 8, 128, 4096, 16
#: (dtype, B, c, window, pad rows of the last batch row, label): decode
#: (c 1) and prefill (c 8, 64), the window of 4096 over a ring that has
#: wrapped (first positions 5000 + 315 b) and window 0 over a linear
#: cache (1024 + 315 b, its last block unmapped when paged), B 1 and 4,
#: bf16 and f32. Every case runs the dense cache and the paged pool.
SERVE_MAIN = ("bfloat16", 4, 1, 4096, 0, "decode")
SERVE_PREFILL = ("bfloat16", 4, 64, 4096, 0, "prefill c 64")
SERVE_CASES = [SERVE_MAIN,
               ("bfloat16", 1, 1, 4096, 0, "decode, B 1"),
               ("bfloat16", 4, 1, 0, 0, "decode, linear"),
               ("bfloat16", 4, 8, 4096, 3, "prefill c 8, pads"),
               SERVE_PREFILL,
               ("bfloat16", 4, 64, 4096, 17, "prefill c 64, pads"),
               ("bfloat16", 1, 64, 0, 5, "prefill c 64, linear, B 1"),
               ("float32", 4, 1, 4096, 0, "decode f32"),
               ("float32", 2, 64, 4096, 9, "prefill c 64 f32, pads"),
               ("float32", 2, 8, 0, 0, "prefill c 8 f32, linear")]
SERVE_TIMED = (SERVE_MAIN, SERVE_PREFILL,
               ("bfloat16", 4, 8, 4096, 3, "prefill c 8, pads"))
#: slice 17's head ratios, as a 7th field the query heads over the same 8
#: kv heads: mixtral-8x22b's 48 (n_rep 6, its window of 4096 over a
#: wrapped ring), mistral-large-123b's 96 (12) and llama3-405b's 128 (16)
#: over a linear cache; decode and a prefill chunk of 64, all timed
SERVE_WIDE = [("bfloat16", 4, 1, 4096, 0, "decode, n_rep 6", 48),
              ("bfloat16", 4, 64, 4096, 0, "prefill c 64, n_rep 6", 48),
              ("bfloat16", 4, 1, 0, 0, "decode, n_rep 12", 96),
              ("bfloat16", 4, 64, 0, 5, "prefill c 64, n_rep 12", 96),
              ("bfloat16", 4, 1, 0, 0, "decode, n_rep 16", 128),
              ("bfloat16", 4, 64, 0, 0, "prefill c 64, n_rep 16", 128)]
#: slice 20: phi-3-vision-4.2b's decode and prefill chunk, 32 query heads
#: over 32 kv heads of 96 (n_rep 1; 8th and 9th fields: kv heads, hd)
#: over a linear cache
SERVE_VLM = [("bfloat16", 4, 1, 0, 0, "vlm decode, hd 96, n_rep 1", 32, 32,
              96),
             ("bfloat16", 4, 64, 0, 5, "vlm prefill c 64, hd 96", 32, 32,
              96)]
SERVE_CASES += SERVE_WIDE + SERVE_VLM
SERVE_TIMED += tuple(SERVE_WIDE) + tuple(SERVE_VLM)


def serve_state(torch, g, ref, dtype, B, c, window, pads, H=SERVE_H,
                KH=SERVE_KH, hd=SERVE_HD):
    """One serving-attention input at minitron's shape: the cache of a
    ring of SERVE_L slots before a chunk of c rows (every slot holding the
    latest position below the chunk's first, of that slot's residue), the
    chunk's q (pre-scaled), k, v and positions (the last batch row's last
    ``pads`` rows PAD_POS); the same logical cache as a dense cache and as
    a paged pool under a shuffled table (blocks of SERVE_BS; under window
    0 each row's last block, empty, unmapped: the null block)."""
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    L, bs = SERVE_L, SERVE_BS
    p0 = torch.tensor([(L + 904 if window else L // 4) + L // 13 * b
                       for b in range(B)], device=dev)
    s = torch.arange(L, device=dev)
    cpos = p0[:, None] - 1 - torch.remainder(p0[:, None] - 1 - s, L)
    cpos = torch.where(cpos >= 0, cpos, -1).to(torch.int32)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(
        *shape, device=dev, generator=g)).to(dt)
    ck, cv = rnd(B, L, KH, hd), rnd(B, L, KH, hd)
    q = rnd(B, c, H, hd, scale=hd ** -0.5)
    kn, vn = rnd(B, c, KH, hd), rnd(B, c, KH, hd)
    pos = (p0[:, None] + torch.arange(c, device=dev)).to(torch.int32)
    if pads:
        pos[-1, c - pads:] = ref.PAD_POS
    mb = L // bs
    perm = torch.randperm(B * mb, device=dev, generator=g) + 1
    table = perm.reshape(B, mb).to(torch.int32)
    if not window:
        table[:, -1] = 0
    NB = 1 + B * mb
    pk = rnd(NB, bs, KH, hd)            # block 0 holds garbage
    pv = rnd(NB, bs, KH, hd)
    ppos = torch.full((NB, bs), -1, dtype=torch.int32, device=dev)
    flat = table.long().flatten()
    pk[flat] = ck.reshape(B * mb, bs, KH, hd)
    pv[flat] = cv.reshape(B * mb, bs, KH, hd)
    ppos[flat] = cpos.reshape(B * mb, bs)
    pk[0], pv[0], ppos[0] = rnd(bs, KH, hd), rnd(bs, KH, hd), 7
    ring = torch.full((B,), L, dtype=torch.int32, device=dev)
    return dict(q=q, k=kn, v=vn, pos=pos, dense=(ck, cv, cpos),
                paged=(pk, pv, ppos, table, ring))


def serve_visible(torch, ref, pos, cpos, window) -> int:
    """Query-slot pairs the mask lets through (the work this input needs):
    each row's effective slots (its chunk's writes up to it over the old
    contents) within (position - window, position]."""
    B, c = pos.shape
    L = cpos.shape[1]
    ring = torch.full((B,), L, dtype=torch.int32, device=pos.device)
    src = ref.serve_chunk_sources(pos, ring, None, L, L)
    newp = torch.gather(pos.long(), 1, src.clamp(max=c - 1))
    total = 0
    for i in range(c):
        eff = torch.where(src <= i, newp, cpos.long())
        p = pos[:, i:i + 1].long()
        m = (eff >= 0) & (eff <= p)
        if window:
            m &= eff > p - window
        total += int(m.sum())
    return total


def serve_row_at_c1(torch, sa, st, i, window):
    """Row i of the chunk computed alone (c = 1) against the dense cache
    holding the chunk's real rows before it, as the per-token loop
    holds them."""
    ck, cv, cpos = (x.clone() for x in st["dense"])
    pos = st["pos"]
    B, L = cpos.shape
    for j in range(i):
        real = pos[:, j] < (1 << 29)
        b = torch.nonzero(real)[:, 0]
        slot = (pos[b, 0].long() + j) % L
        ck[b, slot], cv[b, slot] = st["k"][b, j], st["v"][b, j]
        cpos[b, slot] = pos[b, j]
    row = lambda x: x[:, i:i + 1].contiguous()
    return sa.serve_attention(row(st["q"]), row(st["k"]), row(st["v"]),
                              row(pos), ck, cv, cpos, window=window)[:, 0]


def check_serve_attention(torch, sa, ref, record):
    """serve_attention against its plain version on the same inputs in
    every SERVE_CASES case (FlashAttention's rule: bf16 within twice the
    plain bf16 version's error against the plain version in f32, floor
    1e-3 x max|want|; f32 within atol 1e-5 + rtol 1e-5); the paged pool
    bitwise equal to the dense cache it maps; in the prefill cases rows
    0, 1, c/2 and c-1 (pad rows among them) bitwise equal to that row
    computed at c = 1 against the per-token loop's cache. Device times at
    SERVE_TIMED beside the bound, the plain version and, for the dense
    decode, SDPA over the written cache."""
    import torch.nn.functional as F
    g = torch.Generator(device=torch.device("cuda")).manual_seed(23)
    print("serve_attention: dtype B c window pads case | max err vs plain "
          "(rule) | paged == dense | rows == c=1 rows")
    for case in SERVE_CASES:
        dtype, B, c, window, pads, label, *heads = case
        st = serve_state(torch, g, ref, dtype, B, c, window, pads, *heads)
        args = (st["q"], st["k"], st["v"], st["pos"])
        got = sa.serve_attention(*args, *st["dense"], window=window)
        paged = sa.serve_attention(*args, *st["paged"], window=window)
        want = ref.serve_attention_ref(*args, *st["dense"], window=window)
        f32 = [x.float() if x.is_floating_point() else x
               for x in (*args, *st["dense"])]
        want32 = ref.serve_attention_ref(*f32, window=window)
        torch.cuda.synchronize()
        err = flash_rule(torch, f"serve_attention {label}", got, want32,
                         want)
        check(torch.equal(got, paged),
              f"serve_attention {label}: the paged pool differs from the "
              f"dense cache (max {float((got - paged).abs().max()):.3e})")
        rows = sorted({0, min(1, c - 1), c // 2, c - 1}) if c > 1 else []
        for i in rows:
            one = serve_row_at_c1(torch, sa, st, i, window)
            check(torch.equal(got[:, i], one),
                  f"serve_attention {label}: row {i} of the chunk differs "
                  f"from the row at c = 1 (max "
                  f"{float((got[:, i] - one).abs().max()):.3e})")
        print(f"  {dtype:8s} B={B} c={c:2d} window={window:4d} pads={pads:2d}"
              f" {label:26s} | {err:.3e} | bitwise | "
              f"{'bitwise ' + str(rows) if rows else '-'}")
        rec = dict(case=case, err=err)
        if case in SERVE_TIMED:
            rec.update(time_serve_attention(torch, sa, ref, F, case, st))
        record.append(rec)
        del st, got, paged, want, want32
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    z = torch.zeros(1, 9, 4, 64, device=dev)
    zk = torch.zeros(1, 9, 2, 64, device=dev)
    pos = torch.zeros(1, 9, dtype=torch.int32, device=dev)
    try:
        sa.serve_attention(z, zk, zk, pos, torch.zeros(1, 8, 2, 64,
                                                       device=dev),
                           torch.zeros(1, 8, 2, 64, device=dev),
                           torch.zeros(1, 8, dtype=torch.int32, device=dev))
    except ValueError:
        print("serve_attention: a chunk of 9 rows over a ring of 8 refused")
    else:
        fail("serve_attention took a chunk longer than its ring")


def time_serve_attention(torch, sa, ref, F, case, st):
    """Device times of the kernel (dense and paged), its plain version and,
    for decode over the dense cache, SDPA over the cache with the chunk
    written (``enable_gqa``, a boolean mask), with the bound: the
    function's bytes (q, the chunk's k, v and positions, every cache slot
    and position once, out; the table and rings when paged) against its
    flops (4 hd a visible query-slot pair and head) at the tensor-core
    rate for bf16 (f32: the CUDA cores' rate), and the design's bound
    (P.V, half the flops, at the f32 rate)."""
    dtype, B, c, window, pads, label, *_ = case
    q, k, v, pos = st["q"], st["k"], st["v"], st["pos"]
    ck, cv, cpos = st["dense"]
    s = q.element_size()
    nbytes = ((2 * q.numel() + k.numel() + v.numel() + ck.numel()
               + cv.numel()) * s + (pos.numel() + cpos.numel()) * 4)
    flops = 4 * q.shape[3] * q.shape[2] * serve_visible(torch, ref, pos,
                                                         cpos, window)
    # bf16: the card's bound at the tensor-core rate; the design's keeps
    # P.V (half the flops) on the CUDA cores at the f32 rate
    bf16 = dtype == "bfloat16"
    bnd, by = bound_ms(nbytes, flops,
                       BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
    design = max(nbytes / HBM_BYTES_PER_S, flops / 2 / BF16_FLOPS_PER_S
                 + flops / 2 / F32_FLOPS_PER_S) * 1e3 if bf16 else bnd
    ms = device_ms(torch, lambda: sa.serve_attention(
        q, k, v, pos, ck, cv, cpos, window=window), reps=10, replays=10)
    ms_paged = device_ms(torch, lambda: sa.serve_attention(
        q, k, v, pos, *st["paged"], window=window), reps=10, replays=10)
    plain = slow_ms(torch, lambda: ref.serve_attention_ref(
        q, k, v, pos, ck, cv, cpos, window=window))
    lib = None
    if c == 1:
        bidx = torch.arange(B, device=q.device)
        slot = pos[:, 0].long() % SERVE_L
        kk, vv, pp = ck.clone(), cv.clone(), cpos.clone()
        kk[bidx, slot], vv[bidx, slot], pp[bidx, slot] = k[:, 0], v[:, 0], \
            pos[:, 0]
        m = (pp >= 0) & (pp <= pos)
        if window:
            m &= pp > pos - window
        qt, kt, vt = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
        mask = m[:, None, None, :]
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=1.0, enable_gqa=True),
            reps=10, replays=10)
    print(f"  {label}: kernel {ms:.4f} ms dense, {ms_paged:.4f} paged | "
          f"bound {bnd:.4f} ({by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP), the design's {design:.4f} | plain "
          f"{plain:.4f} | SDPA {'-' if lib is None else f'{lib:.4f}'}"
          + ("" if lib is None else
             f" (decode {'no slower than' if ms <= lib else 'slower than'}"
             f" SDPA: {ms / lib:.2f}x)"))
    return dict(ms=ms, ms_paged=ms_paged, plain_ms=plain, library_ms=lib,
                nbytes=nbytes, flops=flops, bound_ms=bnd, bound_by=by,
                design_bound_ms=design)


#: slice 20: serve_attention's cross form at whisper-medium's decoder
#: shape (16 query heads over 16 kv heads of 64 against the encoder's
#: 1,500 frames): (dtype, B, c, label); decode and chunks of 8 and 64
CROSS_L, CROSS_H, CROSS_HD = 1500, 16, 64
CROSS_MAIN = ("bfloat16", 4, 1, "decode")
CROSS_CASES = [CROSS_MAIN, ("bfloat16", 4, 8, "chunk 8"),
               ("bfloat16", 4, 64, "chunk 64"),
               ("float32", 4, 1, "decode f32"),
               ("float32", 2, 64, "chunk 64 f32")]
CROSS_TIMED = (CROSS_MAIN, ("bfloat16", 4, 64, "chunk 64"))


def check_serve_cross(torch, sa, ref, record):
    """serve_attention's cross form (``serve_cross_attention``) against
    its plain version in every CROSS_CASES case under FlashAttention's
    rule, one launch a call on its own count (the self form's untouched);
    every row of a chunk bitwise that row computed at c = 1. Device times
    at CROSS_TIMED beside the bound (q, the encoder's K/V and out once,
    bytes at 3.35 TB/s, against 4 hd flops a query-key pair and head at
    the dtype's rate), the plain version and SDPA (``enable_gqa``, no
    mask) as the library call."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    L, H, hd = CROSS_L, CROSS_H, CROSS_HD
    print(f"serve_cross_attention (L {L}, {H} heads of {hd}): dtype B c | "
          "max err vs plain (rule) | rows == c=1 rows | kernel ms, bound, "
          "plain, SDPA")
    for case in CROSS_CASES:
        dtype, B, c, label = case
        dt = getattr(torch, dtype)
        q = (hd ** -0.5 * torch.randn(B, c, H, hd, device=dev,
                                      generator=g)).to(dt)
        ek, ev = (torch.randn(B, L, H, hd, device=dev, generator=g).to(dt)
                  for _ in "kv")
        sa.reset_counts()
        got = sa.serve_cross_attention(q, ek, ev)
        check((sa.serve_cross_attention.launches,
               sa.serve_attention.launches) == (1, 0),
              f"serve_cross_attention {label}: not one launch of its own")
        want = ref.serve_cross_attention_ref(q, ek, ev)
        want32 = ref.serve_cross_attention_ref(q.float(), ek.float(),
                                               ev.float())
        torch.cuda.synchronize()
        err = flash_rule(torch, f"serve_cross_attention {label}", got,
                         want32, want)
        for i in range(c):
            one = sa.serve_cross_attention(q[:, i:i + 1].contiguous(), ek,
                                           ev)
            check(torch.equal(got[:, i], one[:, 0]),
                  f"serve_cross_attention {label}: row {i} differs from "
                  "the row at c = 1")
        rec = dict(case=case, err=err)
        line = "-"
        if case in CROSS_TIMED:
            s_ = q.element_size()
            nbytes = (2 * q.numel() + ek.numel() + ev.numel()) * s_
            flops = 4 * hd * H * c * L * B
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S
                               if dt == torch.bfloat16 else F32_FLOPS_PER_S)
            ms = device_ms(torch, lambda: sa.serve_cross_attention(q, ek, ev),
                           reps=10, replays=10)
            plain = slow_ms(torch, lambda: ref.serve_cross_attention_ref(
                q, ek, ev))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, ek, ev))
            lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=1.0, enable_gqa=True), reps=10, replays=10)
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, nbytes=nbytes,
                       flops=flops, bound_ms=bnd, bound_by=by)
            line = (f"{ms:.4f} ms, bound {bnd:.4f} ({by}: "
                    f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain "
                    f"{plain:.4f}, SDPA {lib:.4f}")
        print(f"  {dtype:8s} B={B} c={c:2d} {label:12s} | {err:.3e} | "
              f"bitwise, {c} rows | {line}")
        record.append(rec)
        del q, ek, ev, got, want, want32
        torch.cuda.empty_cache()


#: minitron-8b's serving projections (d_in, d_out) at its published widths
#: (d 4096, 32 heads and 8 kv heads of 128, d_ff 16384, vocabulary 256000)
DENSE_PROJ = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
              "wo": (4096, 4096), "w_in": (4096, 16384),
              "w_gate": (4096, 16384), "w_out": (16384, 4096),
              "lm_head": (4096, 256000)}
#: rows of the bitwise check: a decode step at 1, 4 and 5 requests, a
#: chunk of 64 (the decode form's last), 65, 128 and 129 (the prefill
#: forms' first), four chunks of 64 (the paged engine's prefill), a
#: ragged tail
DENSE_ROWS = (1, 4, 5, 64, 65, 128, 129, 256, 260)
#: the serving path's groups: one launch for the projections of one x
DENSE_GROUPS = {"wq|wk|wv": ("wq", "wk", "wv"),
                "w_in|w_gate": ("w_in", "w_gate")}
#: the timed rows: the decode step (4 slots) and the paged prefill chunk
DENSE_TIMED = (4, 256)
#: a reduced f32 shape (reduced minitron's w_in: d 256, d_ff 512)
DENSE_F32 = (256, 512)
L2_BYTES = 50e6                  # H100 L2: cold reads need more than this


def cold_ms(torch, fn, operands) -> float:
    """device_ms of ``fn(w)`` with w cycling through copies of ``operands``
    summing past twice the L2, so each call reads its weights from device
    memory, as a serving step (16 GB of weights) does."""
    it = iter(range(1 << 30))
    return device_ms(torch, lambda: fn(operands[next(it) % len(operands)]),
                     reps=10, replays=10)


def check_invariant_dense(torch, idn, ref, record):
    """invariant_dense at every minitron-8b serving projection (bf16): every
    row bitwise the same at M in DENSE_ROWS (the rows of M = 260 against
    each smaller call); the max error against the f32 product of the same
    bf16 operands within max(2 x cuBLAS's on the same draws, one bf16 ulp
    of max|ref|); and at a reduced f32 shape rows bitwise and within 1e-5
    of the f64 product. Times at M = 4 and 256 (weights cold: copies past
    the L2) beside the bound (bytes at 3.35 TB/s, flops at 989 TFLOP/s),
    the plain version (``x @ w``, which is ``torch.matmul``) and
    torch.matmul as the library call."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    print("invariant_dense: projection (K, N) split | rows bitwise at M "
          f"{DENSE_ROWS} | err vs f32 product (cuBLAS's) | M: kernel ms "
          "(% HBM peak) bound plain torch.matmul")
    for name, (K, N) in DENSE_PROJ.items():
        w = (torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(
            torch.bfloat16)
        x = torch.randn(max(DENSE_ROWS), K, device=dev, generator=g).to(
            torch.bfloat16)
        full = idn.invariant_dense(x, w)
        for M in DENSE_ROWS[:-1]:
            part = idn.invariant_dense(x[:M].contiguous(), w)
            check(torch.equal(part, full[:M]),
                  f"invariant_dense {name}: rows at M = {M} differ from the "
                  f"same rows at M = {max(DENSE_ROWS)} (max "
                  f"{float((part.float() - full[:M].float()).abs().max()):.3e})")
        ref32 = x.float() @ w.float()
        err = float((full.float() - ref32).abs().max())
        lib_err = float(((x @ w).float() - ref32).abs().max())
        floor = float(ulp(torch, ref32.abs().max(), torch.bfloat16))
        check(err <= max(2 * lib_err, floor),
              f"invariant_dense {name}: max error {err:.3e} beyond twice "
              f"cuBLAS's {lib_err:.3e} (floor {floor:.3e})")
        del ref32
        copies = [w] + [w.clone() for _ in range(
            max(0, math.ceil(2 * L2_BYTES / (K * N * 2)) - 1))]
        times = {}
        for M in DENSE_TIMED:
            xm = x[:M].contiguous()
            nbytes = (M * K + K * N + M * N) * 2
            bnd, by = bound_ms(nbytes, 2 * M * K * N, BF16_FLOPS_PER_S)
            ms = cold_ms(torch, lambda ww: idn.invariant_dense(xm, ww),
                         copies)
            plain = cold_ms(torch, lambda ww: ref.invariant_dense_ref(xm, ww),
                            copies)
            lib = cold_ms(torch, lambda ww: torch.matmul(xm, ww), copies)
            times[M] = (ms, bnd, by, plain, lib)
            record.append(dict(case=(name, M), dtype="bfloat16", K=K, N=N,
                               M=M, split=idn.split_k(K, N), ms=ms,
                               plain_ms=plain, library_ms=lib, bound_ms=bnd,
                               bound_by=by, nbytes=nbytes, err=err,
                               lib_err=lib_err))
        print(f"  {name:8s} ({K}, {N}) S {idn.split_k(K, N)} | bitwise | "
              f"{err:.3e} ({lib_err:.3e}) | " + "; ".join(
                  f"{M}: {ms:.4f} ({(K * N * 2) / (ms * 1e-3) / 3.35e12:.1%})"
                  f" bound {bnd:.4f} plain {plain:.4f} matmul {lib:.4f}"
                  for M, (ms, bnd, by, plain, lib) in times.items()))
        del w, x, full, copies
        torch.cuda.empty_cache()
    check_dense_groups(torch, idn, record)
    check_dense_wide(torch, idn, ref, record)
    check_dense_wide(torch, idn, ref, record, DENSE_F32_EARLIER,
                     "its earlier f32 shapes")
    check_dense_wide(torch, idn, ref, record, DENSE_FAMILIES,
                     "slice 20's widths")
    ms = {r["case"]: r for r in record}
    for M, what in ((4, "decode step (M 4)"),
                    (256, "prefill chunk (M 256: 4 slots x 64 rows)")):
        head = ms[("lm_head", M)]["ms"]
        layer = sum(ms[(n, M)]["ms"] for n in DENSE_PROJ if n != "lm_head")
        grouped = sum(ms[(n, M)]["ms"] for n in (*DENSE_GROUPS, "wo",
                                                 "w_out"))
        lib = sum(ms[(n, M)]["library_ms"] for n in DENSE_PROJ
                  if n != "lm_head")
        print(f"invariant_dense: minitron-8b's 32-layer {what} of "
              f"projections: 32 x {layer:.4f} + lm_head = "
              f"{32 * layer + head:.3f} ms; as the serving path launches "
              f"them (two groups) 32 x {grouped:.4f} + lm_head = "
              f"{32 * grouped + head:.3f} ms; torch.matmul 32 x {lib:.4f} + "
              f"{ms[('lm_head', M)]['library_ms']:.4f} = "
              f"{32 * lib + ms[('lm_head', M)]['library_ms']:.3f} ms")
    K, N = DENSE_F32
    x = torch.randn(max(DENSE_ROWS), K, device=dev, generator=g)
    w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
    full = idn.invariant_dense(x, w)
    for M in DENSE_ROWS[:-1]:
        check(torch.equal(idn.invariant_dense(x[:M].contiguous(), w),
                          full[:M]),
              f"invariant_dense f32 ({K}, {N}): rows at M = {M} differ")
    want = (x.double() @ w.double()).float()
    err = float((full - want).abs().max())
    check(bool(torch.allclose(full, want, rtol=1e-5, atol=1e-5)),
          f"invariant_dense f32 ({K}, {N}): {err:.3e} from the f64 product")
    record.append(dict(case=("reduced f32", max(DENSE_ROWS)), dtype="float32",
                       K=K, N=N, M=max(DENSE_ROWS), err=err))
    print(f"  f32 ({K}, {N}) | bitwise | {err:.3e} vs the f64 product")


def check_dense_groups(torch, idn, record):
    """The serving path's grouped calls at minitron-8b's widths
    (DENSE_GROUPS), with and without bias: one launch a group, each output
    bitwise that problem's single call at M 4 and 256. Times (weights
    cold) beside the bound, the problems' single calls and the sum of
    their ``torch.matmul``; and the eager time (host included, weights
    warm) of one layer's serving projections as 7 single calls and as the
    path launches them (the two groups, wo, w_out)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    x = {}
    warm = {}
    for gname, names in DENSE_GROUPS.items():
        K = DENSE_PROJ[names[0]][0]
        Ns = [DENSE_PROJ[n][1] for n in names]
        ws = [(torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(
            torch.bfloat16) for N in Ns]
        bs = [torch.randn(N, device=dev, generator=g).to(torch.bfloat16)
              for N in Ns]
        if K not in x:
            x[K] = torch.randn(max(DENSE_TIMED), K, device=dev,
                               generator=g).to(torch.bfloat16)
        for M in DENSE_TIMED:
            xm = x[K][:M].contiguous()
            for bias in (False, True):
                probs = list(zip(ws, bs if bias else [None] * len(ws)))
                before = idn.invariant_dense.launches
                got = idn.invariant_dense_group(xm, probs)
                check(idn.invariant_dense.launches - before == 1,
                      f"invariant_dense group {gname}: "
                      f"{idn.invariant_dense.launches - before} launches")
                for n, y, (w, b) in zip(names, got, probs):
                    check(torch.equal(y, idn.invariant_dense(xm, w, b)),
                          f"invariant_dense group {gname} (bias {bias}) at "
                          f"M {M}: {n} differs from its single call")
        sets = [ws] + [[w.clone() for w in ws] for _ in range(max(
            0, math.ceil(2 * L2_BYTES / (K * sum(Ns) * 2)) - 1))]
        line = []
        for M in DENSE_TIMED:
            xm = x[K][:M].contiguous()
            nbytes = (M * K + K * sum(Ns) + M * sum(Ns)) * 2
            bnd, by = bound_ms(nbytes, 2 * M * K * sum(Ns), BF16_FLOPS_PER_S)
            t = cold_ms(torch, lambda wl: idn.invariant_dense_group(
                xm, [(w, None) for w in wl]), sets)
            alone = cold_ms(torch, lambda wl: [idn.invariant_dense(xm, w)
                                               for w in wl], sets)
            lib = cold_ms(torch, lambda wl: [torch.matmul(xm, w)
                                             for w in wl], sets)
            record.append(dict(case=(gname, M), group=names, K=K, N=sum(Ns),
                               M=M, ms=t, alone_ms=alone, library_ms=lib,
                               bound_ms=bnd, bound_by=by, nbytes=nbytes))
            line.append(f"M {M}: {t:.4f} ms (bound {bnd:.4f}, "
                        f"{K * sum(Ns) * 2 / (t * 1e-3) / HBM_BYTES_PER_S:.1%}"
                        f" of HBM peak) single calls {alone:.4f} torch.matmul "
                        f"{lib:.4f}")
        print(f"  group {gname} (K {K}, N {' + '.join(map(str, Ns))}): one "
              f"launch, each output bitwise its single call (bias and none, "
              f"M {DENSE_TIMED}) | " + "; ".join(line))
        warm.update(zip(names, ws))
    for n in ("wo", "w_out"):
        K, N = DENSE_PROJ[n]
        warm[n] = (torch.randn(K, N, device=dev, generator=g) * K ** -0.5
                   ).to(torch.bfloat16)
    xd = x[DENSE_PROJ["wq"][0]][:4].contiguous()
    xf = torch.randn(4, DENSE_PROJ["w_out"][0], device=dev,
                     generator=g).to(torch.bfloat16)

    def singles():
        for n in ("wq", "wk", "wv", "wo", "w_in", "w_gate"):
            idn.invariant_dense(xd, warm[n])
        idn.invariant_dense(xf, warm["w_out"])

    def grouped():
        idn.invariant_dense_group(xd, [(warm[n], None) for n in
                                       DENSE_GROUPS["wq|wk|wv"]])
        idn.invariant_dense(xd, warm["wo"])
        idn.invariant_dense_group(xd, [(warm[n], None) for n in
                                       DENSE_GROUPS["w_in|w_gate"]])
        idn.invariant_dense(xf, warm["w_out"])
    before, after = call_ms(torch, singles), call_ms(torch, grouped)
    record.append(dict(case=("layer call", 4), M=4, call_ms_singles=before,
                       call_ms_grouped=after))
    print(f"  one layer's serving projections at M 4, eager (host "
          f"included, weights warm): 7 single calls {before:.4f} ms, as "
          f"the path launches them (4 calls) {after:.4f} ms")


#: slice 17's serving projections at their published widths, each one
#: launch as the serving path makes it: (label, K, Ns, bias, dtype)
DENSE_WIDE = [
    ("llama3-405b w_in", 16384, (53248,), False, "bfloat16"),
    ("qwen1.5-110b wq|wk|wv", 8192, (8192, 1024, 1024), True, "bfloat16"),
    ("qwen1.5-110b lm_head", 8192, (152064,), False, "bfloat16"),
    ("phi3.5-moe expert pair", 4096, (6400,) * 4, False, "bfloat16"),
    ("phi3.5-moe w_out", 6400, (4096,), False, "bfloat16"),
    ("mixtral-8x22b expert pair", 6144, (16384,) * 4, False, "bfloat16"),
    ("phi3.5-moe router", 4096, (16,), False, "float32"),
    ("mixtral-8x22b router", 6144, (8,), False, "float32")]
#: the f32 shapes the kernel served before slice 17 (the reduced f32
#: serving projections of minitron-8b, as the serving path launches them,
#: and a width of 136) at which its f32 form is timed too
DENSE_F32_EARLIER = [
    ("f32 (256, 136)", 256, (136,), False, "float32"),
    ("reduced minitron-8b wq|wk|wv", 256, (256, 128, 128), False,
     "float32"),
    ("reduced minitron-8b w_out", 512, (256,), False, "float32"),
    ("reduced minitron-8b lm_head", 256, (512,), False, "float32")]
#: slice 20's serving projections at their published widths: the vlm's
#: (phi-3-vision-4.2b: d 3072, 32 heads of 96, d_ff 8192, vocabulary
#: 32,064) and whisper-medium's decoder (d 1024, d_ff 4096 plain GELU,
#: vocabulary 51,865: its lm_head runs padded to 51,872 zero-filled
#: columns, ``invariant_dense.pad_columns``, as ``encdec.serve_params``
#: carries it)
DENSE_FAMILIES = [
    ("phi-3-vision wq|wk|wv", 3072, (3072,) * 3, False, "bfloat16"),
    ("phi-3-vision wo", 3072, (3072,), False, "bfloat16"),
    ("phi-3-vision w_in|w_gate", 3072, (8192,) * 2, False, "bfloat16"),
    ("phi-3-vision w_out", 8192, (3072,), False, "bfloat16"),
    ("phi-3-vision lm_head", 3072, (32064,), False, "bfloat16"),
    ("whisper wq|wk|wv", 1024, (1024,) * 3, False, "bfloat16"),
    ("whisper wo / cross wq", 1024, (1024,), False, "bfloat16"),
    ("whisper w_in", 1024, (4096,), False, "bfloat16"),
    ("whisper w_out", 4096, (1024,), False, "bfloat16"),
    ("whisper lm_head, padded", 1024, (51865,), False, "bfloat16")]
#: the rows held bitwise against M 256's
DENSE_WIDE_ROWS = (1, 4, 65, 256)


def check_dense_wide(torch, idn, ref, record, cases=None,
                     title="slice 17's widths"):
    """invariant_dense at DENSE_WIDE (or ``cases``), each one launch (a
    group where the serving path groups): every row bitwise the same at M in
    DENSE_WIDE_ROWS; bf16 within max(2 x cuBLAS's error, one bf16 ulp of
    max|ref|) of the f32 product (+ bias) of the same operands, f32
    within rtol 1e-5, atol 1e-5 of the f64 product; times at M 4 and 256
    (weights cold) beside the bound (bytes at 3.35 TB/s, flops at the
    dtype's rate), the plain version (``x @ w (+ b)`` a problem) and
    ``torch.matmul`` a problem as the library call. A bf16 width that is
    not a multiple of 8 runs padded with zero columns
    (``idn.pad_columns``), as the serving path carries such a head."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    print(f"invariant_dense at {title}: projection (K, N) | rows "
          f"bitwise at M {DENSE_WIDE_ROWS} | err (cuBLAS's) | M: kernel ms "
          "(% HBM peak) bound plain torch.matmul")
    for label, K, Ns, bias, dtn in cases or DENSE_WIDE:
        dt = getattr(torch, dtn)
        ws = [(torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(dt)
              for N in Ns]
        if dt == torch.bfloat16:
            ws = [idn.pad_columns(w)[0] for w in ws]
            Ns = tuple(w.shape[1] for w in ws)
        bs = [torch.randn(N, device=dev, generator=g).to(dt) if bias
              else None for N in Ns]
        probs = list(zip(ws, bs))
        x = torch.randn(max(DENSE_WIDE_ROWS), K, device=dev,
                        generator=g).to(dt)
        before = idn.invariant_dense.launches
        full = idn.invariant_dense_group(x, probs)
        check(idn.invariant_dense.launches - before == 1,
              f"invariant_dense {label}: not one launch")
        for M in DENSE_WIDE_ROWS[:-1]:
            part = idn.invariant_dense_group(x[:M].contiguous(), probs)
            check(all(torch.equal(a, b[:M]) for a, b in zip(part, full)),
                  f"invariant_dense {label}: rows at M = {M} differ from "
                  f"the same rows at M = {max(DENSE_WIDE_ROWS)}")
        err, lib_err = 0.0, 0.0
        for y, (w, b) in zip(full, probs):
            if dt == torch.float32:
                want = (x.double() @ w.double()).float()
                e = float((y - want).abs().max())
                check(bool(torch.allclose(y, want, rtol=1e-5, atol=1e-5)),
                      f"invariant_dense {label}: {e:.3e} from the f64 "
                      "product")
                err = max(err, e)
                continue
            ref32 = x.float() @ w.float()
            lib = x @ w
            if b is not None:
                ref32, lib = ref32 + b.float(), lib + b
            e = float((y.float() - ref32).abs().max())
            le = float((lib.float() - ref32).abs().max())
            floor = float(ulp(torch, ref32.abs().max(), torch.bfloat16))
            check(e <= max(2 * le, floor), f"invariant_dense {label}: max "
                  f"error {e:.3e} beyond twice cuBLAS's {le:.3e} (floor "
                  f"{floor:.3e})")
            err, lib_err = max(err, e), max(lib_err, le)
            del ref32, lib
        size = x.element_size()
        wbytes = K * sum(Ns) * size
        sets = [probs] + [[(w.clone(), b) for w, b in probs] for _ in range(
            max(0, math.ceil(2 * L2_BYTES / wbytes) - 1))]
        line = []
        for M in DENSE_TIMED:
            xm = x[:M].contiguous()
            nbytes = (M * K + M * sum(Ns)) * size + wbytes + (
                sum(Ns) * size if bias else 0)
            bnd, by = bound_ms(nbytes, 2 * M * K * sum(Ns),
                               BF16_FLOPS_PER_S if dt == torch.bfloat16
                               else F32_FLOPS_PER_S)
            ms = cold_ms(torch, lambda pr: idn.invariant_dense_group(xm, pr),
                         sets)
            plain = cold_ms(torch, lambda pr: [
                ref.invariant_dense_ref(xm, w, b) for w, b in pr], sets)
            lib = cold_ms(torch, lambda pr: [
                torch.matmul(xm, w) if b is None else torch.matmul(xm, w) + b
                for w, b in pr], sets)
            record.append(dict(case=(label, M), dtype=dtn, K=K, N=sum(Ns),
                               problems=len(Ns), M=M, ms=ms, plain_ms=plain,
                               library_ms=lib, bound_ms=bnd, bound_by=by,
                               nbytes=nbytes, err=err, lib_err=lib_err))
            line.append(f"{M}: {ms:.4f} ({wbytes / (ms * 1e-3) / HBM_BYTES_PER_S:.1%}"
                        f") bound {bnd:.4f} plain {plain:.4f} matmul "
                        f"{lib:.4f}")
        print(f"  {label} ({K}, {' + '.join(map(str, Ns))}){' + bias' * bias}"
              f" {dtn} S {[idn.split_k(K, N) for N in Ns]} | bitwise | "
              f"{err:.3e} ({lib_err:.3e}) | " + "; ".join(line))
        del ws, bs, probs, x, full, sets
        torch.cuda.empty_cache()


#: (dtype, d): minitron-8b's width, llama3-405b's (eight warps a row),
#: reduced minitron's f32 width, a width that is not a multiple of the
#: 16-byte vector (the per-element form)
RMS_CASES = (("bfloat16", 4096), ("bfloat16", 16384), ("float32", 256),
             ("bfloat16", 1000),
             # slice 17: mixtral-8x22b's, qwen1.5-110b's and
             # mistral-large-123b's widths
             ("bfloat16", 6144), ("bfloat16", 8192), ("bfloat16", 12288),
             # slice 20: phi-3-vision-4.2b's and whisper-medium's
             ("bfloat16", 3072), ("bfloat16", 1024))
#: the case of the kernels line: minitron-8b's decode step (4 slots)
RMS_MAIN = ("bfloat16", 4096, 4)


#: widths timed also with their rows cold (copies past the L2)
RMS_COLD = (4096, 16384)


def cold_rows_ms(torch, irn, form, operands, nbytes) -> float:
    """device_ms of one ``form`` call ("norm" or "add+norm") whose rows
    come from device memory: each captured call takes its own copy of x
    and h, the copies summing past twice the L2 (the gain is shared)."""
    x, h, gain = operands
    n = max(2, math.ceil(2 * L2_BYTES / nbytes))
    copies = [(x.clone(), h.clone()) for _ in range(n)]
    fn = ((lambda x, h: irn.invariant_rmsnorm(x, gain)) if form == "norm"
          else (lambda x, h: irn.invariant_add_rmsnorm(x, h, gain)))
    it = iter(range(1 << 30))
    return device_ms(torch, lambda: fn(*copies[next(it) % n]), reps=n,
                     replays=10)


def host_ms(torch, fn, iters: int = 200) -> float:
    """Host time of one eager ``fn()`` call: ``iters`` calls back to back
    on the host clock, the device synchronised before and after (the
    device keeps up with calls that cost it less than the host's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def add_norm_pair(torch, irn, record, d=4096, rows=DENSE_TIMED) -> dict:
    """At d (bf16) and each M of ``rows``: the device time (CUDA-graph
    replay), the eager call's time (CUDA events, host included) and the
    host time of one call of the residual add then the norm,
    ``irn.invariant_rmsnorm(x + h, g)`` (the serving path before the
    fused form), and, where ``irn`` has it, of
    ``irn.invariant_add_rmsnorm(x, h, g)``. Uses only what every
    checkout's ``irn`` has, so scripts/phase3_ab.py runs it against
    another checkout (check ``add_norm``). Returns {M: record}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    bf = torch.bfloat16
    x = torch.randn(max(rows), d, device=dev, generator=g).to(bf)
    h = torch.randn(max(rows), d, device=dev, generator=g).to(bf)
    gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    fused = getattr(irn, "invariant_add_rmsnorm", None)
    out = {}
    for M in rows:
        xm, hm = x[:M].contiguous(), h[:M].contiguous()
        calls = {"pair": lambda: irn.invariant_rmsnorm(xm + hm, gain)}
        if fused is not None:
            calls["fused"] = lambda: fused(xm, hm, gain)
        r = dict(case=("add then norm", d, M), d=d, M=M)
        for k, fn in calls.items():
            r.update({f"{k}_ms": device_ms(torch, fn),
                      f"{k}_call_ms": call_ms(torch, fn),
                      f"{k}_host_ms": host_ms(torch, fn)})
        record.append(r)
        out[M] = r
    return out


def check_invariant_rmsnorm(torch, irn, ref, record, fused_record=None):
    """invariant_rmsnorm's two forms at RMS_CASES (bf16 at d 4096 and
    16384, f32 at d 256, bf16 at d 1000): invariant_add_rmsnorm's s
    bitwise ``x + h`` and its y bitwise the norm-only form on s; both
    forms' rows bitwise at M in DENSE_ROWS; within N_ULP of the output
    dtype of their plain versions (``layers.rmsnorm``); each width's plan
    (warps a row, vectors a thread, 16-byte or per element). Times at M 4
    and 256 (inputs in L2, as a serving step finds x and h just written;
    at d 4096 and 16384 also cold, ``cold_rows_ms``) beside the bound
    (bytes: x and h read, s and y written, or x read and y written; and
    g), the plain version and the library yardstick
    (``F.rms_norm``, after ``x + h`` for the fused form); then the add
    followed by the norm against the fused call (``add_norm_pair``).
    The fused form's records go to ``fused_record`` (default
    ``record``)."""
    import torch.nn.functional as F
    fused_record = record if fused_record is None else fused_record
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    print("invariant_rmsnorm: both forms, rows bitwise at M "
          f"{DENSE_ROWS}; M: kernel ms, bound, plain, library (F.rms_norm; "
          "x + h then F.rms_norm for add+norm)")
    for dtype, d in RMS_CASES:
        dt = getattr(torch, dtype)
        tag = f"{dtype} d {d}"
        x = torch.randn(max(DENSE_ROWS), d, device=dev, generator=g).to(dt)
        h = torch.randn(max(DENSE_ROWS), d, device=dev, generator=g).to(dt)
        gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        full = irn.invariant_rmsnorm(x, gain)
        s, y = irn.invariant_add_rmsnorm(x, h, gain)
        check(torch.equal(s, x + h),
              f"invariant_add_rmsnorm {tag}: s differs from x + h")
        check(torch.equal(y, irn.invariant_rmsnorm(s, gain)),
              f"invariant_add_rmsnorm {tag}: y differs from the norm-only "
              "form on s")
        for M in DENSE_ROWS[:-1]:
            xm, hm = x[:M].contiguous(), h[:M].contiguous()
            check(torch.equal(irn.invariant_rmsnorm(xm, gain), full[:M]),
                  f"invariant_rmsnorm {tag}: rows at M = {M} differ")
            sm, ym = irn.invariant_add_rmsnorm(xm, hm, gain)
            check(torch.equal(sm, s[:M]) and torch.equal(ym, y[:M]),
                  f"invariant_add_rmsnorm {tag}: rows at M = {M} differ")
        want = ref.invariant_rmsnorm_ref(x, gain)
        err = compare(torch, f"invariant_rmsnorm {tag}", full, want,
                      want.float().abs(), dt)
        _, want = ref.invariant_add_rmsnorm_ref(x, h, gain)
        err_f = compare(torch, f"invariant_add_rmsnorm {tag}", y, want,
                        want.float().abs(), dt)
        plan = irn.plan(d, dt)
        line = []
        for M in DENSE_TIMED:
            xm, hm = x[:M].contiguous(), h[:M].contiguous()
            forms = (
                ("norm", record, 2, err,
                 lambda: irn.invariant_rmsnorm(xm, gain),
                 lambda: ref.invariant_rmsnorm_ref(xm, gain),
                 lambda: F.rms_norm(xm, (d,), gain, 1e-6)),
                ("add+norm", fused_record, 4, err_f,
                 lambda: irn.invariant_add_rmsnorm(xm, hm, gain),
                 lambda: ref.invariant_add_rmsnorm_ref(xm, hm, gain),
                 lambda: F.rms_norm(xm + hm, (d,), gain, 1e-6)))
            for form, rec, n_rows, e, fn, plain_fn, lib_fn in forms:
                nbytes = (n_rows * M * d + d) * x.element_size()
                bnd, by = bound_ms(nbytes, (3 + n_rows // 2) * M * d)
                ms = device_ms(torch, fn)
                plain = device_ms(torch, plain_fn)
                lib = device_ms(torch, lib_fn)
                cold = None
                if dt == torch.bfloat16 and d in RMS_COLD:
                    cold = cold_rows_ms(torch, irn, form, (xm, hm, gain),
                                        nbytes)
                rec.append(dict(case=(dtype, d, M), form=form, M=M, ms=ms,
                                cold_ms=cold, plain_ms=plain,
                                library_ms=lib, bound_ms=bnd, bound_by=by,
                                nbytes=nbytes, err=e, plan=plan))
                line.append(f"{form} M {M}: {ms:.4f}" + (
                    "" if cold is None else f" (cold {cold:.4f})") +
                    f" bound {bnd:.5f} plain {plain:.4f} lib {lib:.4f}")
        print(f"  {tag}: plan (warps {plan[0]}, vectors {plan[1]}, "
              f"{'16-byte' if plan[2] else 'per element'}) | bitwise | err "
              f"norm {err:.3e}, add+norm {err_f:.3e} (within "
              f"{N_ULP[dtype]} ulp) | " + "; ".join(line))
    for M, r in add_norm_pair(torch, irn, fused_record).items():
        print(f"  bf16 d 4096 M {M}: x + h then invariant_rmsnorm (the path "
              f"before) {r['pair_ms']:.4f} ms device, eager call "
              f"{r['pair_call_ms']:.4f}, host {r['pair_host_ms']:.4f} | "
              f"invariant_add_rmsnorm {r['fused_ms']:.4f} ms device, eager "
              f"call {r['fused_call_ms']:.4f}, host "
              f"{r['fused_host_ms']:.4f}")


# ------------------------------------------------------------ phase 4/5 ---

QUICKSTART = ["--clients", "20", "--clients-per-round", "5", "--p-limited",
              "0.5", "--lr", "0.1", "--n-train", "1500", "--eval-every", "5"]
MODERATE_30 = ["--p-delay", "0.3", "--max-delay", "10"]


def run_train(torch, train, argv):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, hist = train.main(argv)
    torch.cuda.synchronize()
    return sim, hist, time.perf_counter() - t0


def leaves_of(tree_mod, state):
    return [x for _, x in tree_mod.flatten({"params": state["params"],
                                            "aux": state["aux"]})]


Q8 = ["--comm-plane", "q8"]
BANDWIDTH = ["--env", "bandwidth", "--max-delay", "5"]

#: (label, argv, the one server kernel the run launches); every run is
#: at the paper CNN's full width on the quickstart config
MAIN_RUNS = [
    ("ama_fes", ["--algorithm", "ama_fes", "--rounds", "60"], "server_mix"),
    ("fedavg", ["--algorithm", "fedavg", "--rounds", "60"], "server_mix"),
    ("async_ama", ["--algorithm", "async_ama", *MODERATE_30,
                   "--rounds", "30"], "server_async"),
    ("fedprox", ["--algorithm", "fedprox", "--rounds", "60"], "server_mix"),
    ("fedopt", ["--algorithm", "fedopt", "--rounds", "60"], "server_adam"),
    ("ama_fes+q8", ["--algorithm", "ama_fes", *Q8, "--rounds", "60"],
     "server_mix_delta"),
    ("fedavg+bf16", ["--algorithm", "fedavg", "--comm-plane", "bf16",
                     "--rounds", "30"], "server_mix_delta"),
    ("ama_fes+topk", ["--algorithm", "ama_fes", "--comm-plane", "topk",
                      "--comm-topk-frac", "0.01", "--rounds", "60"],
     "server_mix_scatter"),
    ("fedopt+q8", ["--algorithm", "fedopt", *Q8, "--rounds", "30"],
     "server_adam"),
    ("async_ama+q8", ["--algorithm", "async_ama", *MODERATE_30, *Q8,
                      "--rounds", "30"], "server_async"),
    ("fedavg bandwidth", ["--algorithm", "fedavg", *BANDWIDTH,
                          "--rounds", "30"], "server_mix"),
    ("fedavg bandwidth+q8", ["--algorithm", "fedavg", *BANDWIDTH, *Q8,
                             "--rounds", "30"], "server_mix_delta"),
]


PARTITIONED = ["--client-plane", "partitioned"]

#: slice 11: the partitioned client plane on the quickstart config, each
#: run the argv of the masked MAIN_RUNS run of its name plus the plane
PARTITIONED_RUNS = [
    ("ama_fes partitioned", ["--algorithm", "ama_fes", *PARTITIONED,
                             "--rounds", "60"], "server_mix"),
    ("fedprox partitioned", ["--algorithm", "fedprox", *PARTITIONED,
                             "--rounds", "60"], "server_mix"),
    ("async_ama partitioned", ["--algorithm", "async_ama", *MODERATE_30,
                               *PARTITIONED, "--rounds", "30"],
     "server_async"),
    ("fedopt partitioned", ["--algorithm", "fedopt", *PARTITIONED,
                            "--rounds", "60"], "server_adam"),
]


LEGACY = ["--server-plane", "legacy", "--use-kernel"]

#: slice 3: the legacy per-leaf chain on the ama_mix kernel, one launch
#: a round for all 8 leaves (one dtype pair), at the paper CNN's full
#: width on the quickstart config
LEGACY_RUNS = [
    ("legacy ama_fes", ["--algorithm", "ama_fes", *LEGACY, "--rounds", "30"],
     "ama_mix"),
    ("legacy fedavg", ["--algorithm", "fedavg", *LEGACY, "--rounds", "30"],
     "ama_mix"),
    ("legacy fedprox", ["--algorithm", "fedprox", *LEGACY, "--rounds", "30"],
     "ama_mix"),
    ("legacy fedopt", ["--algorithm", "fedopt", *LEGACY, "--rounds", "30"],
     "ama_mix"),
    ("legacy async_ama", ["--algorithm", "async_ama", *MODERATE_30, *LEGACY,
                          "--rounds", "30"], "ama_mix"),
]


class CountCudaCalls:
    """Counts the calls of ``module.name`` on CUDA tensors while
    installed: the plain version of a kernel must not run on the card on
    the main path (the wrapper reaches it only for CPU tensors)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.real = getattr(module, name)

    def __enter__(self):
        def counted(x, *args, **kw):
            if x.is_cuda:
                self.calls += 1
            return self.real(x, *args, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def vector_readers(sp):
    """(kernel, its design-count reader) of the server kernels whose
    main-path launches must all take the 16-byte kernel."""
    return [("server_async", sp.server_async_designs),
            ("server_adam", sp.server_adam_designs),
            ("server_mix_delta", sp.server_mix_delta_designs)]


def main_path(torch, train, sp, ref, tree_mod, runs, main_record):
    """The main-path runs; returns {kernel: launches}. Each run's counts
    are set to 0 just before it and read just after: its kernel launched
    exactly rounds x dtype groups times (``ama_mix``: one group for each
    (prev, rows) dtype pair, the CNN's one; ``server_async``,
    ``server_adam`` and ``server_mix_delta`` every time on their 16-byte
    kernels), every other kernel never, and the plain server version
    never on the card."""
    totals = dict.fromkeys(sp.KERNELS, 0)
    for label, argv, kernel in runs:
        argv = [*QUICKSTART, *argv]
        sp.reset_counts()
        vec_before = {k: read()["vector"] for k, read in vector_readers(sp)}
        with CountCudaCalls(ref, "ama_mix_math") as plain_mix:
            sim, hist, dt = run_train(torch, train, argv)
        counts = {k: fn.launches for k, fn in sp.KERNELS.items()}
        vec = {k: read()["vector"] - vec_before[k]
               for k, read in vector_readers(sp)}
        plain = dict(sp.plain_runs_on_cuda, ama_mix_math=plain_mix.calls)
        rounds = int(argv[argv.index("--rounds") + 1])
        groups = len(tree_mod.dtype_groups(tree_mod.leaves(sim.params)))
        extra = ""
        on_time = None
        if "bandwidth" in label:
            delayed = sim.env.batch(0, rounds)["delayed"]
            on_time = float(1.0 - delayed.mean())
            extra = f"; on-time share {on_time:.4f} of {delayed.size} uploads"
        split = sim.runner.limited_split
        if split is not None:
            n_lim = int(sim.env.batch(0, rounds)["limited"].sum())
            extra += (f"; limited cohort-rounds: {split['limited_program']} "
                      f"on the limited program, {split['overflow']} "
                      "overflowed to the masked one")
            check(sum(split.values()) == n_lim, f"{label}: limited split "
                  f"{split} does not cover the {n_lim} limited cohort-rounds")
        print(f"main path {label}: {rounds} rounds in {dt:.3f} s = "
              f"{rounds / dt:.2f} rounds/s (staging, training, server "
              f"kernel and evaluation every 5 rounds); final_accuracy="
              f"{hist.final_accuracy():.4f} stability_variance="
              f"{hist.stability_variance():.3f}{extra}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; plain on the "
              f"card {sum(plain.values())}")
        check(counts[kernel] == rounds * groups,
              f"{label}: {kernel} launched {counts[kernel]} times, expected "
              f"{rounds} rounds x {groups} dtype groups")
        if kernel in vec:
            # the CNN's K 5, N 54,784 operands (N = 16 x 3,424) take the
            # 16-byte kernel
            check(vec[kernel] == counts[kernel], f"{label}: {vec[kernel]} of "
                  f"{counts[kernel]} {kernel} launches on the vector kernel")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{label}: other kernels launched: {others}")
        check(all(v == 0 for v in plain.values()),
              f"{label}: the plain server version ran on the card: {plain}")
        check(sim.t == rounds, f"{label}: ended at round {sim.t}")
        for x in leaves_of(tree_mod, sim.state):
            check(x.is_cuda and bool(torch.isfinite(x).all()),
                  f"{label}: non-finite or off-card state")
        acc = hist.final_accuracy()
        check(0.0 <= acc <= 1.0, f"{label}: final accuracy {acc}")
        if label in ("ama_fes", "fedavg", "legacy ama_fes"):
            # the CNN learns the synthetic task (chance 0.1); fedavg's 30
            # legacy rounds are too few for it (best 0.285 on the card)
            check(max(hist.test_acc) > 0.3,
                  f"{label}: best test accuracy {max(hist.test_acc)}")
        check(all(x == x for x in hist.train_loss), f"{label}: NaN loss")
        totals[kernel] += counts[kernel]
        main_record.append(dict(run=label, rounds=rounds, seconds=dt,
                                rounds_per_s=rounds / dt,
                                final_accuracy=acc, on_time=on_time,
                                stability_variance=hist.stability_variance(),
                                limited_split=split))
    return totals


def planes_side_by_side(main_record):
    """Each partitioned CNN run beside the masked run of the same
    algorithm and argv, from this process's main-path records."""
    by = {r["run"]: r for r in main_record}
    for label, _, _ in PARTITIONED_RUNS:
        p, m = by[label], by[label.replace(" partitioned", "")]
        print(f"client planes, CNN {m['run']}: masked {m['rounds_per_s']:.2f}"
              f" rounds/s (final_accuracy {m['final_accuracy']:.4f}), "
              f"partitioned {p['rounds_per_s']:.2f} rounds/s "
              f"(final_accuracy {p['final_accuracy']:.4f}; limited "
              f"cohort-rounds {p['limited_split']})")


def fes_static_cnn(torch, train, sp, tree_mod, main_record):
    """ama_fes under ``FLConfig(fes_static=True)`` through the launcher's
    ``paper_scale``: every cohort differentiates only the classifier.
    The server_mix kernel launched once a round and no plain version on
    the card; the classifier leaves moved; the body leaves (conv*) were
    not trained: each within rounds x (K + 2) f32 ulp of its start, the
    rounding the mix a_eff * p + sum_k c_k * p of identical bodies may
    add a round (K products and adds; bitwise equality is reported)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import build_model
    rounds = 30
    args = train.parser().parse_args([*QUICKSTART, "--algorithm", "ama_fes",
                                      "--rounds", str(rounds)])
    fl = train.fl_config(args).with_(fes_static=True)
    dev = torch.device("cuda")
    p0 = dict(tree_mod.flatten(build_model(get_arch(args.arch)).init(
        torch.Generator().manual_seed(fl.seed), dev)))
    sp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, hist = train.paper_scale(args, fl, dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in sp.KERNELS.items() if fn.launches}
    check(counts == {"server_mix": rounds}, f"fes_static: launches {counts}, "
          f"expected server_mix {rounds}")
    check(sum(sp.plain_runs_on_cuda.values()) == 0,
          f"fes_static: the plain server version ran on the card: "
          f"{sp.plain_runs_on_cuda}")
    K, worst, exact = fl.clients_per_round, 0.0, True
    for path, x in tree_mod.flatten(sim.params):
        x0 = p0[path]
        check(x.is_cuda and bool(torch.isfinite(x).all()),
              f"fes_static: {path} non-finite or off the card")
        if path.startswith("body/"):
            drift = float(((x - x0).abs() / ulp(torch, x0,
                                                 torch.float32)).max())
            worst, exact = max(worst, drift), exact and torch.equal(x, x0)
            check(drift <= rounds * (K + 2), f"fes_static: body leaf {path} "
                  f"moved {drift:.0f} ulp in {rounds} rounds")
        else:
            check(not torch.equal(x, x0), f"fes_static: classifier leaf "
                  f"{path} did not move")
    acc = hist.final_accuracy()
    body = ("bitwise unchanged" if exact
            else f"within {worst:.0f} ulp of their start")
    print(f"main path ama_fes fes_static: {rounds} rounds in {dt:.3f} s = "
          f"{rounds / dt:.2f} rounds/s; final_accuracy={acc:.4f}; launches "
          f"{counts}; body leaves {body} (bound {rounds * (K + 2)} ulp), "
          "classifier moved")
    main_record.append(dict(run="ama_fes fes_static", rounds=rounds,
                            seconds=dt, rounds_per_s=rounds / dt,
                            final_accuracy=acc, body_max_ulp=worst,
                            body_bitwise=exact))
    return counts


def fused_vs_plain(torch, train, tree_mod):
    """A few rounds with the kernels against the same rounds with the
    plain server versions, on the card: the same params and aux within
    the kernel tolerance compounded over the rounds (and reported when
    bitwise equal)."""
    for label, extra in (("ama_fes", []),
                         ("async_ama", ["--algorithm", "async_ama",
                                        *MODERATE_30]),
                         ("fedopt", ["--algorithm", "fedopt"]),
                         ("ama_fes+q8", Q8),
                         ("ama_fes+topk", ["--comm-plane", "topk"])):
        argv = ["--algorithm", "ama_fes", *QUICKSTART, *extra,
                "--rounds", "10"]
        a, _, _ = run_train(torch, train, argv)
        b, _, _ = run_train(torch, train, argv + ["--server-plane", "ref"])
        worst, exact = 0.0, True
        for x, y in zip(leaves_of(tree_mod, a.state),
                        leaves_of(tree_mod, b.state), strict=True):
            d = float((x.float() - y.float()).abs().max()) if x.numel() else 0
            worst = max(worst, d)
            exact = exact and torch.equal(x, y)
            check(torch.allclose(x.float(), y.float(), rtol=1e-5, atol=1e-6),
                  f"{label}: fused vs plain server plane differ by {d:.3e}")
        print(f"fused vs plain server plane, {label}, 10 rounds: max |diff| "
              f"{worst:.3e} (tolerance rtol 1e-5, atol 1e-6)"
              f"{', bitwise equal' if exact else ''}")


def client_planes_per_cohort(torch, tree_mod):
    """One round's local training of the paper CNN on the card, 5 cohorts
    (2 limited) x 3 steps x 8 images from a seed, for each of ama_fes,
    fedprox and fedopt: the partitioned plane against the masked plane
    per cohort within rtol 1e-6, atol 1e-7 (the CPU tests' gate for
    limited cohorts); whether the unlimited cohorts, which run the masked
    program over 3 cohorts instead of 5, come out bitwise is reported."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.client import (make_local_train,
                                         make_partitioned_local_train)
    from repro_torch.core.round import as_scan_scheds
    from repro_torch.data.pipeline import partition_plan
    from repro_torch.models.api import build_model
    dev = torch.device("cuda")
    model = build_model(get_arch("paper-cnn"))
    params = model.init(torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(0)
    batch = {"image": torch.as_tensor(rng.randn(5, 3, 8, 28, 28, 1).astype(
                 np.float32), device=dev),
             "label": torch.as_tensor(rng.randint(0, 10, (5, 3, 8)).astype(
                 np.int32), device=dev)}
    limited = np.array([[True, False, True, False, False]])
    sb = {"limited": limited, "delayed": np.zeros((1, 5), bool),
          "delays": np.ones((1, 5), np.int32),
          "data_sizes": np.ones((1, 5), np.float32),
          **partition_plan(limited)}
    sched = {k: v[0] for k, v in as_scan_scheds(sb, dev).items()}
    for algo in ("ama_fes", "fedprox", "fedopt"):
        fl = FLConfig(algorithm=algo, lr=0.05, fedprox_rho=0.01)
        m, ml = make_local_train(model, fl)(params, batch, sched["limited"])
        p, pl = make_partitioned_local_train(model, fl)(params, batch, sched)
        worst, exact = 0.0, True
        for x, y in zip(tree_mod.leaves(m), tree_mod.leaves(p), strict=True):
            worst = max(worst, float((x - y).abs().max()))
            check(torch.allclose(x, y, rtol=1e-6, atol=1e-7),
                  f"client planes {algo}: partitioned and masked cohorts "
                  f"differ by {worst:.3e}")
            exact = exact and all(torch.equal(x[c], y[c])
                                  for c in (1, 3, 4))
        check(torch.allclose(ml, pl, rtol=1e-6), f"client planes {algo}: "
              f"losses {ml.tolist()} against {pl.tolist()}")
        print(f"client planes on the card, CNN {algo}, one round of 5 "
              f"cohorts (2 limited): partitioned vs masked max |diff| "
              f"{worst:.3e} (tolerance rtol 1e-6, atol 1e-7); unlimited "
              f"cohorts bitwise: {exact}")


def legacy_kernel_vs_plain(torch, train, tree_mod):
    """10 rounds of the legacy chain with --use-kernel against 10 rounds
    without it (plain elementwise math in the kernel's op order), on the
    card: allclose is required, bitwise equality reported."""
    for label, extra in (("ama_fes", []),
                         ("async_ama", ["--algorithm", "async_ama",
                                        *MODERATE_30]),
                         ("fedopt", ["--algorithm", "fedopt"])):
        argv = ["--algorithm", "ama_fes", *QUICKSTART, *extra,
                "--server-plane", "legacy", "--rounds", "10"]
        a, _, _ = run_train(torch, train, argv + ["--use-kernel"])
        b, _, _ = run_train(torch, train, argv)
        worst, exact = 0.0, True
        for x, y in zip(leaves_of(tree_mod, a.state),
                        leaves_of(tree_mod, b.state), strict=True):
            d = float((x.float() - y.float()).abs().max()) if x.numel() else 0
            worst = max(worst, d)
            exact = exact and torch.equal(x, y)
            check(torch.allclose(x.float(), y.float(), rtol=1e-5, atol=1e-6),
                  f"legacy {label}: --use-kernel vs plain differ by {d:.3e}")
        print(f"legacy chain, {label}, 10 rounds: --use-kernel vs plain max "
              f"|diff| {worst:.3e} (tolerance rtol 1e-5, atol 1e-6)"
              f"{', bitwise equal' if exact else ', NOT bitwise equal'}")


def where_time_goes(torch, train):
    """10 rounds of the AMA-FES main path under torch.profiler: device
    time by kernel and the device's busy share of the wall time (the
    profiler's own host cost is in that wall time)."""
    from torch.profiler import ProfilerActivity, profile
    argv = ["--algorithm", "ama_fes", *QUICKSTART, "--rounds", "10"]
    _, _, plain_dt = run_train(torch, train, argv)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, dt = run_train(torch, train, argv)
    rows = []
    for e in prof.key_averages():
        # the engine's record_function regions (obs.timing.annotate) also
        # appear as device-side ranges; they span kernels, not add to them
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e3
    print(f"where the time goes, ama_fes 10 rounds: {dt * 1e3:.1f} ms wall "
          f"under the profiler ({plain_dt * 1e3:.1f} ms without), device "
          f"busy {busy:.1f} ms = {busy / (dt * 1e3):.1%} of the wall")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {key[:100]}")


def _states_equal(torch, tree_mod, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        leaves_of(tree_mod, a.state), leaves_of(tree_mod, b.state),
        strict=True))


RESTART = 10                     # rounds before and after the restart


def restart_contract(torch, train, tree_mod, tmp):
    """chunked == per-round == save -> restore -> continue, bitwise,
    params and all aux (ring buffer; fedopt's m, v and step): 20 rounds
    chunked, 20 per round, and 10 rounds --checkpoint then --resume and
    10 more."""
    whole, half = str(2 * RESTART), str(RESTART)
    for label, extra in (("ama_fes", []),
                         ("async_ama", ["--algorithm", "async_ama",
                                        *MODERATE_30]),
                         ("fedopt", ["--algorithm", "fedopt"])):
        argv = ["--algorithm", "ama_fes", *QUICKSTART, *extra]
        ck = str(Path(tmp) / f"{label}.npz")
        a, ha, _ = run_train(torch, train, argv + ["--rounds", whole])
        b, hb, _ = run_train(torch, train, argv + ["--rounds", whole,
                                                   "--no-scan"])
        run_train(torch, train, argv + ["--rounds", half, "--checkpoint",
                                        ck])
        c, hc, _ = run_train(torch, train, argv + ["--rounds", half,
                                                   "--resume", ck])
        check(c.t == 2 * RESTART, f"{label}: resumed run ended at round "
              f"{c.t}")
        check(_states_equal(torch, tree_mod, a, b),
              f"{label}: chunked and per-round runs differ")
        check(_states_equal(torch, tree_mod, a, c),
              f"{label}: save -> restore -> continue differs from the "
              "uninterrupted run")
        check(ha.test_acc == hb.test_acc and ha.train_loss == hb.train_loss
              and hc.eval_rounds == [t for t in ha.eval_rounds
                                     if t > RESTART]
              and hc.test_acc == ha.test_acc[len(ha.test_acc)
                                              - len(hc.test_acc):]
              and hc.train_loss == ha.train_loss[RESTART:],
              f"{label}: the histories of the three runs differ")
        print(f"port contract: 20 rounds of {label} chunked == per round "
              "(--no-scan) == 10 rounds, --checkpoint, --resume, 10 more; "
              "bitwise, params and all aux")


def prefetch_and_metrics(torch, train, tree_mod, tmp):
    """--prefetch-depth 0, 1 (the default) and 2 give bitwise the same
    state; --metrics-out leaves the params stream bitwise as with it
    off, and its JSONL validates."""
    from repro_torch.obs.log import read_rows, validate_rows
    from repro_torch.obs.metrics import ROUND_METRIC_KEYS
    argv = ["--algorithm", "async_ama", *QUICKSTART, *MODERATE_30,
            "--rounds", "10"]
    base, _, _ = run_train(torch, train, argv)
    for depth in ("0", "2"):
        other, _, _ = run_train(torch, train,
                                argv + ["--prefetch-depth", depth])
        check(_states_equal(torch, tree_mod, base, other),
              f"--prefetch-depth {depth} changed the state")
    print("prefetch: 10 rounds of async_ama at --prefetch-depth 0, 1 and 2,"
          " bitwise equal")
    for plane in ([], LEGACY):
        jsonl = str(Path(tmp) / "metrics.jsonl")
        off, _, _ = run_train(torch, train, argv + plane)
        on, hist, _ = run_train(torch, train,
                                argv + plane + ["--metrics-out", jsonl])
        check(_states_equal(torch, tree_mod, off, on),
              "--metrics-out changed the params stream")
        rows = read_rows(jsonl)
        errs = validate_rows(rows)
        check(not errs, f"metrics JSONL: {errs[:3]}")
        rnd = [r for r in rows if r["kind"] == "round"]
        check(len(rnd) == 10 and all(set(ROUND_METRIC_KEYS) <= set(r)
                                     for r in rnd),
              "metrics JSONL: missing round rows or keys")
        check(rows[0]["provenance"]["backend"] == "cuda",
              "metrics JSONL: header does not name the card")
        print(f"telemetry {'legacy ' if plane else ''}async_ama: "
              "--metrics-out on == off bitwise; JSONL valid (10 round "
              f"rows, alpha_eff {rnd[0]['alpha_eff']:.4f} -> "
              f"{rnd[-1]['alpha_eff']:.4f}, stale_hist "
              f"{[sum(c) for c in zip(*(r['stale_hist'] for r in rnd))]})")


def port_contract(torch, train, tree_mod):
    for label, extra in (("async_ama", ["--algorithm", "async_ama",
                                        *MODERATE_30]),
                         ("fedopt", ["--algorithm", "fedopt"]),
                         ("ama_fes+q8", Q8),
                         ("async_ama partitioned",
                          ["--algorithm", "async_ama", *MODERATE_30,
                           *PARTITIONED])):
        argv = ["--algorithm", "ama_fes", *QUICKSTART, *extra,
                "--rounds", "10"]
        a, ha, _ = run_train(torch, train, argv)
        b, hb, _ = run_train(torch, train, argv + ["--no-scan"])
        for x, y in zip(leaves_of(tree_mod, a.state),
                        leaves_of(tree_mod, b.state), strict=True):
            check(torch.equal(x, y), f"{label}: chunked and per-round runs "
                  "differ")
        check(ha.test_acc == hb.test_acc and ha.train_loss == hb.train_loss,
              f"{label}: chunked and per-round histories differ")
        print(f"port contract: 10 rounds of {label} chunked (eval_every 5) "
              "== per round (--no-scan), bitwise, params and all aux")


# ------------------------------------- slice 12: the host plane's worlds ---

#: the paper's delay settings and the beyond-paper channels by scenario
#: name (``repro_torch.env.scenarios``), async_ama on the quickstart
#: config; ama_fes under bursty-severe too (max_delay > 0 makes it the
#: asynchronous strategy, as in the JAX package)
SCENARIOS = ("clear", "moderate-30", "severe-70", "bursty", "bursty-severe",
             "bandwidth-limited", "mobility-trace")
SCENARIO_RUNS = ([(sc, "async_ama") for sc in SCENARIOS]
                 + [("bursty-severe", "ama_fes")])
SCENARIO_ROUNDS = 30


def _designs_of(sp):
    return {"server_async": sp.server_async_designs(),
            "server_mix": sp.server_mix_designs()}


def _design_delta(before, after, kernel) -> dict:
    return {d: n - before[kernel][d] for d, n in after[kernel].items()}


def _server_kernel(sim) -> str:
    return ("server_async" if type(sim.strategy).__name__
            == "AsyncAMAStrategy" else "server_mix")


def _same_run(torch, tree_mod, a, ha, b, hb) -> bool:
    return (_states_equal(torch, tree_mod, a, b)
            and ha.train_loss == hb.train_loss and ha.test_acc == hb.test_acc)


def scenario_runs(torch, train, sp, ref, tree_mod, main_record):
    """Phase (a) of slice 12: each of SCENARIO_RUNS for 30 rounds through
    the launcher's --scenario, at the CNN's full width. Counts set to 0
    just before each run and read just after: its server kernel launched
    exactly once a round (one dtype group), every launch on the 16-byte
    kernel (K 5, Q = max_delay + 1: 16 under bursty-severe), no other
    kernel and no plain version on the card. Reported: the share of
    uploads delayed, their mean and largest delay, the final accuracy
    and the stability variance. bursty-severe and mobility-trace again
    with --server-plane ref (bitwise equal), bursty-severe again with
    --no-scan (bitwise equal), and ama_fes == async_ama under
    bursty-severe (one strategy). Returns {kernel: launches}."""
    totals = dict.fromkeys(sp.KERNELS, 0)
    runs = {}
    for scenario, algo in SCENARIO_RUNS:
        label = f"{algo} {scenario}"
        argv = [*QUICKSTART, "--algorithm", algo, "--scenario", scenario,
                "--rounds", str(SCENARIO_ROUNDS)]
        sp.reset_counts()
        before = _designs_of(sp)
        with CountCudaCalls(ref, "ama_mix_math") as plain_mix:
            sim, hist, dt = run_train(torch, train, argv)
        counts = {k: fn.launches for k, fn in sp.KERNELS.items()}
        kernel = _server_kernel(sim)
        design = _design_delta(before, _designs_of(sp), kernel)
        plain = dict(sp.plain_runs_on_cuda, ama_mix_math=plain_mix.calls)
        fl, rounds = sim.fl, SCENARIO_ROUNDS
        groups = len(tree_mod.dtype_groups(tree_mod.leaves(sim.params)))
        check(counts[kernel] == rounds * groups,
              f"{label}: {kernel} launched {counts[kernel]} times, expected "
              f"{rounds} rounds x {groups} dtype groups")
        check(design["vector"] == counts[kernel], f"{label}: {design} of "
              f"{counts[kernel]} {kernel} launches on the vector kernel")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{label}: other kernels launched: {others}")
        check(all(v == 0 for v in plain.values()),
              f"{label}: the plain server version ran on the card: {plain}")
        check(sim.t == rounds, f"{label}: ended at round {sim.t}")
        for x in leaves_of(tree_mod, sim.state):
            check(x.is_cuda and bool(torch.isfinite(x).all()),
                  f"{label}: non-finite or off-card state")
        Q = (int(sim.aux["queue"]["gamma"].shape[0])
             if kernel == "server_async" else None)
        if scenario == "bursty-severe":
            check(fl.max_delay == 15 and Q == 16,
                  f"{label}: max_delay {fl.max_delay}, ring of {Q} slots")
        sb = sim.env.batch(0, rounds)
        delayed, delays = sb["delayed"], sb["delays"]
        check(int(delays.max()) <= max(fl.max_delay, 1)
              and bool((delays[~delayed] == 1).all()),
              f"{label}: delays outside 1..{fl.max_delay}")
        share = float(delayed.mean())
        mean_delay = float(delays[delayed].mean()) if delayed.any() else 0.0
        acc = hist.final_accuracy()
        check(0.0 <= acc <= 1.0 and all(x == x for x in hist.train_loss),
              f"{label}: final accuracy {acc} or a NaN loss")
        print(f"scenario {label}: env {fl.env}, max_delay {fl.max_delay}, "
              f"ring Q={Q}; {rounds} rounds in {dt:.3f} s = "
              f"{rounds / dt:.2f} rounds/s; delayed {share:.4f} of "
              f"{delayed.size} uploads, mean delay {mean_delay:.3f}, "
              f"largest {int(delays.max())}; final_accuracy={acc:.4f} "
              f"stability_variance={hist.stability_variance():.3f}; "
              f"{kernel} launches {counts[kernel]} {design}")
        totals[kernel] += counts[kernel]
        runs[(scenario, algo)] = (sim, hist)
        main_record.append(dict(
            run=f"scenario {label}", rounds=rounds, seconds=dt,
            rounds_per_s=rounds / dt, env=fl.env, max_delay=fl.max_delay,
            ring_q=Q, delayed_share=share, mean_delay=mean_delay,
            max_delay_drawn=int(delays.max()), final_accuracy=acc,
            stability_variance=hist.stability_variance(),
            kernel=kernel, launches=counts[kernel], designs=design))
    acc = {sc: runs[(sc, "async_ama")][1].final_accuracy()
           for sc in SCENARIOS}
    print(f"scenario accuracies (async_ama): {acc}; bursty-severe (15 "
          f"rounds of staleness) - moderate-30: "
          f"{acc['bursty-severe'] - acc['moderate-30']:+.4f}")
    a, ha = runs[("bursty-severe", "async_ama")]
    b, hb = runs[("bursty-severe", "ama_fes")]
    check(_same_run(torch, tree_mod, a, ha, b, hb),
          "bursty-severe: ama_fes and async_ama (one strategy) differ")
    for scenario in ("bursty-severe", "mobility-trace"):
        a, ha = runs[(scenario, "async_ama")]
        argv = [*QUICKSTART, "--algorithm", "async_ama", "--scenario",
                scenario, "--rounds", str(SCENARIO_ROUNDS)]
        sp.reset_counts()
        b, hb, _ = run_train(torch, train, argv + ["--server-plane", "ref"])
        check(sum(fn.launches for fn in sp.KERNELS.values()) == 0,
              f"{scenario}: a kernel launched under --server-plane ref")
        check(_same_run(torch, tree_mod, a, ha, b, hb),
              f"{scenario}: fused and plain server planes differ")
        print(f"scenario {scenario}: 30 rounds of async_ama fused == "
              "--server-plane ref, bitwise, params, ring and histories")
    a, ha = runs[("bursty-severe", "async_ama")]
    b, hb, _ = run_train(torch, train, [
        *QUICKSTART, "--algorithm", "async_ama", "--scenario",
        "bursty-severe", "--rounds", str(SCENARIO_ROUNDS), "--no-scan"])
    check(_same_run(torch, tree_mod, a, ha, b, hb),
          "bursty-severe: chunked and per-round runs differ")
    print("scenario bursty-severe: 30 rounds of async_ama chunked "
          "(eval_every 5) == per round (--no-scan), bitwise; ama_fes == "
          "async_ama, bitwise")
    return totals


#: slice 12 phase (b), as the JAX package's benchmarks/federation_scale.py
#: (_fl) defines a cell: ama_fes (asynchronous under max_delay 6: a ring
#: of Q = 7), Bernoulli p_delay 0.3, one local epoch of batch 16 over a
#: shard of 32 (2 steps), over a 2,048-sample store
FED_POPULATIONS = (1_000, 1_000_000)
FED_COHORTS = (5, 32, 128)
FED_SHARD = 32
FED_ROUNDS = 10
FED_REPEATS = 3


def fed_config(FLConfig, K: int, C: int, algorithm: str = "ama_fes"):
    return FLConfig(num_clients=K, clients_per_round=C, local_epochs=1,
                    local_batch_size=16, lr=0.1, algorithm=algorithm,
                    env="bernoulli", p_delay=0.3, max_delay=6,
                    population="auto", seed=0)


def federation_scale(torch, sp, tree_mod, main_record):
    """Phase (b) of slice 12: the engine (FederatedSimulation) over
    VirtualClientShards at K 1,000 (dense schedule) and 1,000,000
    (virtual) x C 5, 32, 128, plus async_ama at K 1,000,000, C 32. Each
    cell: one warm-up run, then FED_REPEATS timed runs of FED_ROUNDS
    rounds (one chunk, one eval each), rounds/s best and spread, the
    engine's "stage" span (schedule + staging) per round over the timed
    runs, server_async launched exactly once a round on the kernel its
    cohort takes (16-byte for C <= 8, per element above), and the
    K 10^6 / K 10^3 ratio per C; the schedule alone at K 10^6, C 128,
    Bernoulli against Gilbert-Elliott. Then K 1,000 with population
    "virtual" over the shards == over a dense ClientDataset list of
    their shard views, bitwise. Returns {kernel: launches}."""
    from repro_torch import env as env_mod
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.pipeline import ClientDataset, VirtualClientShards
    from repro_torch.data.synth import make_image_classification
    from repro_torch.env.virtual import VIRTUAL_K_MIN
    from repro_torch.models.api import build_model
    dev = torch.device("cuda")
    model = build_model(get_arch("paper-cnn"))
    data, test = make_image_classification(n_train=2048, n_test=256, seed=0)
    totals = dict.fromkeys(sp.KERNELS, 0)
    best = {}
    cells = [(K, C, "ama_fes") for C in FED_COHORTS for K in FED_POPULATIONS]
    cells.append((1_000_000, 32, "async_ama"))
    for K, C, algo in cells:
        fl = fed_config(FLConfig, K, C, algo)
        shards = VirtualClientShards(data, K, shard_size=FED_SHARD,
                                     seed=fl.seed)
        sim = FederatedSimulation(model, fl, shards, test, device=dev)
        check(sim.env.virtual == (K > VIRTUAL_K_MIN),
              f"K={K}: population virtual is {sim.env.virtual}")
        sp.reset_counts()
        before = _designs_of(sp)
        sim.run(rounds=FED_ROUNDS, eval_every=FED_ROUNDS)   # warm-up
        stage0 = sim.timer.summary().get("stage", {"seconds": 0.0})
        times = []
        for _ in range(FED_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(rounds=FED_ROUNDS, eval_every=FED_ROUNDS)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        stage = sim.timer.summary()["stage"]
        timed = FED_REPEATS * FED_ROUNDS
        stage_ms = (stage["seconds"] - stage0["seconds"]) / timed * 1e3
        kernel = _server_kernel(sim)
        counts = {k: fn.launches for k, fn in sp.KERNELS.items()}
        design = _design_delta(before, _designs_of(sp), kernel)
        rounds = (FED_REPEATS + 1) * FED_ROUNDS
        want = "vector" if C <= 8 else "per_element"
        label = f"federation K={K} C={C} {algo}"
        check(kernel == "server_async" and counts[kernel] == rounds,
              f"{label}: {kernel} launched {counts[kernel]} times, "
              f"expected {rounds}")
        check(design[want] == rounds, f"{label}: designs {design}, "
              f"expected every launch on {want}")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{label}: other kernels launched: {others}")
        check(sum(sp.plain_runs_on_cuda.values()) == 0,
              f"{label}: the plain server version ran on the card")
        check(sim.t == rounds, f"{label}: ended at round {sim.t}")
        for x in leaves_of(tree_mod, sim.state):
            check(x.is_cuda and bool(torch.isfinite(x).all()),
                  f"{label}: non-finite or off-card state")
        rps = [FED_ROUNDS / t for t in times]
        best[(K, C, algo)] = max(rps)
        print(f"{label}: population "
              f"{'virtual' if sim.env.virtual else 'dense'}, shards of "
              f"{FED_SHARD} over {shards.n} samples (K x shard = "
              f"{K * FED_SHARD:,}), ring Q={fl.max_delay + 1}; rounds/s "
              f"best {max(rps):.2f} of {FED_REPEATS} x {FED_ROUNDS} rounds "
              f"(spread {max(rps) - min(rps):.2f}: "
              f"{', '.join(f'{r:.2f}' for r in rps)}); stage (schedule + "
              f"staging, host) {stage_ms:.3f} ms/round; {kernel} launches "
              f"{counts[kernel]} {design}")
        totals[kernel] += counts[kernel]
        main_record.append(dict(
            run=label, population="virtual" if sim.env.virtual else "dense",
            rounds_per_s=max(rps), rounds_per_s_all=rps,
            stage_ms_per_round=stage_ms, kernel=kernel, designs=design,
            launches=counts[kernel]))
        del sim
    lo, hi = FED_POPULATIONS
    for C in FED_COHORTS:
        r = best[(hi, C, "ama_fes")] / best[(lo, C, "ama_fes")]
        print(f"federation C={C}: rounds/s at K={hi:,} over K={lo:,} = "
              f"{r:.3f}")
        main_record.append(dict(run=f"federation ratio C={C}", ratio=r))
    # the host's schedule alone at K 10^6, C 128: Bernoulli's vectorised
    # hashed draws against Gilbert-Elliott's per-client chains (a Python
    # loop over the block's clients, memoized per client)
    for env_name in ("bernoulli", "gilbert_elliott"):
        environment = env_mod.resolve(
            fed_config(FLConfig, 1_000_000, 128).with_(env=env_name),
            data_sizes=shards.client_sizes)
        t0 = time.perf_counter()
        for t in range(0, 3 * FED_ROUNDS, FED_ROUNDS):
            environment.batch(t, FED_ROUNDS)
        ms = (time.perf_counter() - t0) / (3 * FED_ROUNDS) * 1e3
        print(f"federation K=1,000,000 C=128 {env_name} schedule alone "
              f"(host, virtual): {ms:.3f} ms/round over 3 chunks of "
              f"{FED_ROUNDS}")
        main_record.append(dict(run=f"federation schedule {env_name}",
                                schedule_ms_per_round=ms))
    # a virtual population over the shards == a dense list of them
    fl = fed_config(FLConfig, 1_000, 5).with_(population="virtual")
    shards = VirtualClientShards(data, 1_000, shard_size=FED_SHARD,
                                 seed=fl.seed)
    dense = [ClientDataset(data, shards.shard_indices(i))
             for i in range(1_000)]
    sims = [FederatedSimulation(model, fl, c, test, device=dev)
            for c in (shards, dense)]
    sp.reset_counts()
    hists = [s.run(rounds=FED_ROUNDS, eval_every=5) for s in sims]
    totals["server_async"] += sp.KERNELS["server_async"].launches
    check(sp.KERNELS["server_async"].launches == 2 * FED_ROUNDS,
          "federation: streamed vs dense, server_async launches "
          f"{sp.KERNELS['server_async'].launches}")
    check(sims[0].env.virtual and sims[1].env.virtual
          and _same_run(torch, tree_mod, sims[0], hists[0], sims[1],
                        hists[1]),
          "federation: K=1,000 virtual over shards and over a dense list "
          "differ")
    print(f"federation K=1,000 population virtual: {FED_ROUNDS} rounds "
          "over VirtualClientShards == over a dense ClientDataset list of "
          "its shard views, bitwise")
    return totals


# ------------------------------------------------------- the LLM paths ---

#: the pod path at full width: 2 cohorts x 2 local steps x 1 x 2048 tokens
POD_ROUNDS, POD_STEPS, POD_C, POD_B, POD_S = 3, 2, 2, 1, 2048

#: arch -> its full-width depth cut (layers, FES tail layers), parameter
#: count there, the plain versions of its kernels, the name its kernels
#: carry in a trace, and its forward kernels (with the config's remat on,
#: each block runs forward twice, in the forward and in the backward's
#: recompute: these launch twice a layer a local step, the backward
#: kernels once). minitron-8b: 2 of 32 layers (one body, one tail block);
#: rwkv6-3b: 8 of 32 (6 body, the config's own 2 tail blocks), then once
#: at the deepest depth whose peak memory is predicted within 70 GB
#: (rwkv6_deep); phi3.5-moe: 2 of 32 (one body, one tail block). mixtral
#: and qwen run reduced only (their full-width layer does not leave room
#: for two cohorts beside it at 2 layers, PERF.md).
_FLASH = dict(plain=("flash_attention_ref", "flash_bwd_dq_ref",
                     "flash_bwd_dkdv_ref"), trace="flash_",
              parts=("flash_fwd", "flash_bwd"), fwd=("flash_fwd",))
PHI = "phi3.5-moe-42b-a6.6b"
ZAMBA = "zamba2-1.2b"
VLM = "phi-3-vision-4.2b"
WHISPER = "whisper-medium"
LLMS = {
    "minitron-8b": dict(layers=2, tail=1, params=LLM_N, **_FLASH),
    "rwkv6-3b": dict(layers=8, tail=2, params=RWKV_N,
                     plain=("rwkv6_scan_ref", "rwkv6_scan_bwd_ref"),
                     trace="rwkv6_", parts=("rwkv6_fwd", "rwkv6_bwd"),
                     fwd=("rwkv6_fwd",)),
    PHI: dict(layers=2, tail=1, params=PHI_N, **_FLASH),
    "mixtral-8x22b": dict(_FLASH),
    "qwen1.5-110b": dict(_FLASH),
    # slice 18: two kernel families, the mamba2 recurrence a layer (its
    # forward twice under remat) and flash at the shared-attention
    # sites (``sites``: after each group of attn_every blocks, outside
    # remat); all 38 layers (6 sites); remat on == off is held at reduced
    # size (``zamba2_reduced_on_card``). Slice 19: a wrapper's device
    # kernels are told apart by ``part_kernels`` (the chunk form's state
    # and pass kernels serve both directions, told apart by their
    # template arguments in the trace)
    ZAMBA: dict(layers=38, tail=2, params=ZAMBA_N, remat_off=False,
                plain=("mamba2_scan_ref", "mamba2_scan_bwd_ref",
                       *_FLASH["plain"]),
                trace="mamba2_", parts=("mamba2_fwd", "mamba2_bwd",
                                        "flash_fwd", "flash_bwd"),
                part_kernels={
                    "mamba2_fwd": r"mamba2_(step_kernel|out_kernel|"
                                  r"state_kernel<\d+, false>|"
                                  r"pass_kernel<false>)",
                    "mamba2_bwd": r"mamba2_(grad_kernel|bwd_heads_kernel|"
                                  r"state_kernel<\d+, true>|"
                                  r"pass_kernel<true>)"},
                fwd=("mamba2_fwd", "flash_fwd"),
                sites=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")),
    # slice 20: phi-3-vision-4.2b at 24 of 32 layers (576 patches + 2,048
    # tokens = 2,624 rows through flash at hd 96; remat on == off is held
    # at reduced size). All 32 peak at 62.57 GB in a fresh process, but
    # after the earlier phases the allocator's free blocks (34 GiB
    # reserved, unallocated) left no room for server_mix's 14.25 GiB
    # (K, N) stack at 32: out of memory. whisper-medium at all 24 + 24
    # (each encoder block one flash call, each decoder block two:
    # plan_launches)
    VLM: dict(layers=24, tail=2, params=VLM_N, remat_off=False, **_FLASH),
    WHISPER: dict(layers=24, tail=2, params=WHISPER_N, **_FLASH),
}


class KernelSet:
    """Kernel modules seen as one (``KERNELS``, ``reset_counts`` and, if
    one has it, ``design_launches``): an arch whose path runs more than
    one kernel family."""

    def __init__(self, *mods):
        self.mods = mods
        self.KERNELS = {k: v for m in mods for k, v in m.KERNELS.items()}
        for m in mods:
            if hasattr(m, "design_launches"):
                self.design_launches = m.design_launches

    def reset_counts(self):
        for m in self.mods:
            m.reset_counts()


#: the archs whose full-width pod runs (``llm_full_width``) repeat over
#: phases 4-7 and so share one parameter draw (``MemoInit``)
MEMO_ARCHS = ("minitron-8b", "rwkv6-3b", PHI, ZAMBA, VLM)


class MemoInit:
    """A ``with`` block in which the model API's ``transformer.init_params``
    draws each of ``cfgs`` (remat aside) once: the first call for a
    config and seed takes the real init on the card (the launcher's own
    path) and keeps a CPU copy of the tree and the generator's state
    after the draw; each later call for it from a fresh seeded CPU
    generator, as the launcher makes, copies that tree to the card and
    leaves the generator where the draw would: the same values without
    another ~25 s of CPU time. ``drop(cfg)`` frees a config's copy after
    its last run. Other calls take the real init."""

    def __init__(self, tf, cfgs):
        self.tf, self.real, self.trees = tf, tf.init_params, {}
        self.cfgs = {c.with_(remat=True) for c in cfgs}

    def __enter__(self):
        import torch

        from repro_torch.utils.tree import tree_map

        def init(cfg, gen, device=None):
            key = (cfg.with_(remat=True), gen.initial_seed())
            fresh = gen.device.type == "cpu" and torch.equal(
                gen.get_state(),
                torch.Generator().manual_seed(key[1]).get_state())
            if key[0] not in self.cfgs or not fresh or device is None \
                    or torch.device(device).type != "cuda":
                return self.real(cfg, gen, device)
            if key not in self.trees:
                out = self.real(cfg, gen, device)
                self.trees[key] = (tree_map(lambda x: x.cpu(), out),
                                   gen.get_state())
                return out
            tree, after = self.trees[key]
            gen.set_state(after)
            return tree_map(lambda x: x.to(device), tree)
        self.tf.init_params = init
        return self

    def drop(self, cfg):
        base = cfg.with_(remat=True)
        self.trees = {k: v for k, v in self.trees.items() if k[0] != base}

    def __exit__(self, *exc):
        self.tf.init_params = self.real
        self.trees.clear()


def plan_launches(arch, cfg, km, chunks, partitioned: bool):
    """{kernel: launches} of the arch's kernels over a pod run's
    dispatches, ``chunks`` each dispatch's (rounds, C) limited flags.
    Every round of a dispatch runs the masked program over U = C - L
    cohorts when U > 0 (each block's forward kernels once a layer a
    step, twice under remat, and its backward kernels once) and, under
    the partitioned plane with L > 0, the classifier program over L
    cohorts (a body block's forward kernels once and no backward; a tail
    block as in the masked program); L is the dispatch's least limited
    count (0 on the masked plane); one vmapped call covers a program's
    cohorts. The hybrid family's ``sites`` kernels run once a
    shared-attention site (outside remat) instead of once a layer. An
    encoder-decoder counts attention calls: an encoder block one (in the
    body, the feature extractor), a decoder block two (its self- and
    cross-attention)."""
    tail = min(cfg.fes_tail_layers, cfg.num_layers)
    body = cfg.num_layers - tail
    if cfg.family == "audio":
        body, tail = cfg.encoder_layers + 2 * body, 2 * tail
    per = 2 if cfg.remat else 1
    spec = LLMS[arch]
    sites = [n // cfg.attn_every if cfg.attn_every and n >= cfg.attn_every
             else 0 for n in (body, tail)]
    out = dict.fromkeys(km.KERNELS, 0)
    for lim in chunks:
        n, C = lim.shape
        L = int(lim.sum(axis=1).min()) if partitioned else 0
        for name in out:
            fwd = name in spec["fwd"]
            b, t = sites if name in spec.get("sites", ()) else (body, tail)
            rep = per if fwd and name not in spec.get("sites", ()) else 1
            full = (b + t) * rep
            limited = t * rep + (b if fwd else 0)
            out[name] += n * POD_STEPS * ((full if C - L else 0)
                                          + (limited if L else 0))
    return out


def pod_chunks(train, argv):
    """Each dispatch's (rounds, C) limited flags of ``pod_scale`` run
    with ``argv`` from round 0: the launcher's own environment, one
    chunk of every round, or one a round under --no-scan."""
    from repro_torch import env as env_mod
    args = train.parser().parse_args(argv)
    fl = train.fl_config(args)
    C = fl.cohorts
    env = env_mod.resolve(fl.with_(num_clients=C, clients_per_round=C))
    if args.no_scan:
        return [env.batch(r, 1)["limited"] for r in range(args.rounds)]
    return [env.batch(0, args.rounds)["limited"]]


def limited_split_of(chunks) -> dict:
    """The ChunkRunner's ``limited_split`` under the partitioned plane
    for these dispatches."""
    on = sum(lim.shape[0] * int(lim.sum(axis=1).min()) for lim in chunks)
    return {"limited_program": on,
            "overflow": sum(int(lim.sum()) for lim in chunks) - on}


class KeepRunner:
    """Keeps each ``ChunkRunner`` that ``launch.train`` makes while
    installed: its phase times (the steady rounds' seconds) and its
    ``limited_split``."""

    def __init__(self, train):
        self.train, self.runners = train, []

    def __enter__(self):
        self.real = real = self.train.ChunkRunner
        runners = self.runners

        class Kept(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                runners.append(self)
        self.train.ChunkRunner = Kept
        return self

    def __exit__(self, *exc):
        self.train.ChunkRunner = self.real


def pod_argv(arch):
    return ["--arch", arch, "--pod", "--cohorts", str(POD_C),
            "--local-steps", str(POD_STEPS), "--batch", str(POD_B), "--seq",
            str(POD_S), "--p-limited", "0.5"]


def llm_full_width(arch):
    """The arch at its published widths, depth cut as LLMS says."""
    from repro_torch.configs.registry import get_arch
    spec = LLMS[arch]
    return get_arch(arch).with_(num_layers=spec["layers"],
                                fes_tail_layers=spec["tail"])


def llm_reduced(arch):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    return reduced(get_arch(arch), dtype="float32")


def reduced_pod(arch):
    """The reduced LLM path (the config comes from llm_reduced())."""
    return ["--arch", arch, "--pod", "--reduced", "--cohorts", str(POD_C),
            "--local-steps", str(POD_STEPS), "--p-limited", "0.5",
            "--algorithm", "ama_fes"]


def run_pod(torch, train, argv, cfg, device="cuda"):
    args = train.parser().parse_args(argv)
    return train.pod_scale(args, train.fl_config(args), torch.device(device),
                           cfg)


class CountPlain:
    """Counts the calls of ``ref``'s plain versions ``names`` on CUDA
    tensors while installed (the wrappers reach them only for CPU
    tensors)."""

    def __init__(self, ref, names):
        self.counters = [CountCudaCalls(ref, n) for n in names]

    def __enter__(self):
        for c in self.counters:
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c.__exit__(*exc)

    @property
    def calls(self):
        return {c.name: c.calls for c in self.counters}


def pod_main_path(torch, train, arch, km, kmods, ref, tree_mod,
                  main_record):
    """An LLM main path: ``arch`` at full width, with the config's own
    remat on, ama_fes and fedavg, 3 rounds each through
    ``launch.train.pod_scale``. Each run's counts are set to 0 just
    before it and read just after: each of the arch's kernels (``km``)
    launched rounds x local steps x layers times (one vmapped call covers
    both cohorts; the forward kernels twice that, for the recompute), the
    flash kernels all on their tensor-core design, server_mix rounds x
    dtype groups, no other kernel of ``kmods`` (the kernel modules, the
    server plane's first) and no plain version on the card. Then ama_fes
    again with remat off (``remat_off_vs_on``). Returns the counts summed
    over the runs and the ama_fes run's (params copied to the CPU, or None
    without the remat-off run; losses; peak memory). (zamba2 skips the
    remat-off run at full width: its 38 layers' activations; phase 5 holds
    remat on == off at reduced size.)"""
    spec = LLMS[arch]
    cfg = llm_full_width(arch)
    check(cfg.remat, f"{arch}: the config's remat is off")
    sp = kmods[0]
    ln_vocab = math.log(cfg.vocab_size)   # the loss of a uniform guess
    totals, kept = {}, None
    for algo in ("ama_fes", "fedavg"):
        argv = [*pod_argv(arch), "--algorithm", algo, "--rounds",
                str(POD_ROUNDS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in kmods:
            m.reset_counts()
        designs = getattr(km, "design_launches", None)
        before = designs() if designs else None
        t0 = time.perf_counter()
        with CountPlain(ref, spec["plain"]) as plain_calls:
            state, metrics, dt = run_pod(torch, train, argv, cfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = {k: fn.launches for m in kmods
                  for k, fn in m.KERNELS.items()}
        plain = dict(sp.plain_runs_on_cuda, **plain_calls.calls)
        params = tree_mod.leaves(state["params"])
        n_params = sum(x.numel() for x in params)
        groups = len(tree_mod.dtype_groups(params))
        loss = metrics["loss"]
        tokens = POD_ROUNDS * POD_C * POD_STEPS * POD_B * POD_S
        print(f"LLM main path {arch} {algo}: full width, {cfg.num_layers} "
              f"layers, remat on, {n_params:,} params; {POD_ROUNDS} rounds "
              f"in {dt:.3f} s = {POD_ROUNDS / dt:.3f} rounds/s, "
              f"{tokens / dt:,.0f} tokens/s (first-call set-up included; "
              f"{wall:.1f} s with init); losses "
              f"{[round(float(x), 4) for x in loss]}; peak device memory "
              f"{peak / 1e9:.2f} GB; launches "
              f"{ {k: v for k, v in counts.items() if v} }; plain on the "
              f"card {sum(plain.values())}")
        check(n_params == spec["params"], f"{arch} {algo}: {n_params} "
              f"params, expected {spec['params']}")
        check(all(math.isfinite(float(x)) for x in loss),
              f"{arch} {algo}: non-finite loss {loss}")
        check(abs(float(loss[0]) - ln_vocab) < 1.0,
              f"{arch} {algo}: round 0 loss {loss[0]} not within 1.0 of "
              f"ln({cfg.vocab_size})")
        check(float(loss[-1]) < float(loss[0]),
              f"{arch} {algo}: the loss did not fall: {loss}")
        want = plan_launches(arch, cfg, km, pod_chunks(train, argv), False)
        for name, n in want.items():
            check(counts[name] == n,
                  f"{arch} {algo}: {name} launched {counts[name]} times, "
                  f"expected {n} ({POD_ROUNDS} rounds x {POD_STEPS} steps "
                  f"x {cfg.num_layers} layers, forward kernels twice under "
                  "remat)")
        if designs:   # the bf16 model never reaches the CUDA-core kernels
            after = designs()
            moved = {k: {d: after[k][d] - before[k][d] for d in after[k]}
                     for k in after}
            print(f"  launches by design under remat: {moved}")
            check(all(moved[k] == {"cuda_cores": 0, "wgmma": want[k]}
                      for k in moved),
                  f"{arch} {algo}: launches by design {moved}, expected "
                  f"{want} on wgmma")
        check(counts["server_mix"] == POD_ROUNDS * groups,
              f"{arch} {algo}: server_mix launched {counts['server_mix']} "
              f"times, expected {POD_ROUNDS} x {groups} dtype group(s)")
        others = {k: v for k, v in counts.items()
                  if k not in km.KERNELS and k != "server_mix" and v}
        check(not others, f"{arch} {algo}: other kernels launched: {others}")
        check(all(v == 0 for v in plain.values()),
              f"{arch} {algo}: a plain version ran on the card: {plain}")
        check(int(state["t"]) == POD_ROUNDS, f"{arch} {algo}: ended at "
              f"round {int(state['t'])}")
        check(all(x.is_cuda and bool(torch.isfinite(x).all())
                  for x in params), f"{arch} {algo}: non-finite or off-card "
              "params")
        check(peak < 75e9, f"{arch} {algo}: peak device memory "
              f"{peak / 1e9:.2f} GB beyond 75 GB")
        for k in counts:
            totals[k] = totals.get(k, 0) + counts[k]
        main_record.append(dict(run=f"llm {arch} {algo}", rounds=POD_ROUNDS,
                                seconds=dt, rounds_per_s=POD_ROUNDS / dt,
                                tokens_per_s=tokens / dt, remat=True,
                                layers=cfg.num_layers,
                                losses=[float(x) for x in loss],
                                peak_bytes=peak, params=n_params))
        if algo == "ama_fes":
            kept = ([x.cpu() for x in params]
                    if spec.get("remat_off", True) else None, list(loss),
                    peak)
        del state, params
        torch.cuda.empty_cache()
    if spec.get("remat_off", True):
        remat_off_vs_on(torch, train, arch, tree_mod, *kept, main_record)
    return totals, kept


def remat_off_vs_on(torch, train, arch, tree_mod, params_on, loss_on,
                    peak_on, main_record):
    """The ama_fes run of ``pod_main_path`` again with
    ``cfg.with_(remat=False)``: every block's activations kept for the
    backward instead of only its input. Remat changes memory, not
    values: params and losses after the same rounds are bitwise those of
    the remat run (deterministic kernels, TF32 off, deterministic
    cuDNN). Prints the peak memory both ways."""
    cfg = llm_full_width(arch).with_(remat=False)
    argv = [*pod_argv(arch), "--algorithm", "ama_fes", "--rounds",
            str(POD_ROUNDS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, dt = run_pod(torch, train, argv, cfg)
    peak = torch.cuda.max_memory_allocated()
    params = tree_mod.leaves(state["params"])
    same = all(torch.equal(x.cpu(), y)
               for x, y in zip(params, params_on, strict=True))
    tokens = POD_ROUNDS * POD_C * POD_STEPS * POD_B * POD_S
    print(f"remat {arch}, ama_fes, {POD_ROUNDS} rounds, {cfg.num_layers} "
          f"layers: remat off {tokens / dt:,.0f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB; remat on peak {peak_on / 1e9:.2f} GB; "
          f"params and losses bitwise equal: {same and list(metrics['loss']) == loss_on}")
    check(same, f"{arch}: params after {POD_ROUNDS} rounds differ with "
          "remat off and on")
    check(list(metrics["loss"]) == loss_on, f"{arch}: losses differ with "
          f"remat off {list(metrics['loss'])} and on {loss_on}")
    check(peak < 75e9, f"{arch} remat off: peak device memory "
          f"{peak / 1e9:.2f} GB beyond 75 GB")
    main_record.append(dict(run=f"llm {arch} ama_fes remat off",
                            rounds=POD_ROUNDS, seconds=dt,
                            tokens_per_s=tokens / dt, remat=False,
                            layers=cfg.num_layers, peak_bytes=peak,
                            losses=[float(x) for x in metrics["loss"]]))
    del state, params
    torch.cuda.empty_cache()


#: slice 11: the pod runs of the client planes (label, plane, p_limited),
#: ama_fes, --no-scan (each round its own dispatch, so the partitioned
#: plane takes each round's exact split): a mixed round, then all
#: cohorts limited on the masked and on the partitioned plane
POD_PLANE_RUNS = [("partitioned p_limited 0.5", "partitioned", 0.5),
                  ("masked p_limited 1.0", "masked", 1.0),
                  ("partitioned p_limited 1.0", "partitioned", 1.0)]


def pod_client_planes(torch, train, arch, km, kmods, ref, tree_mod,
                      main_record, runs=POD_PLANE_RUNS):
    """The client planes on an LLM main path: ``arch`` at full width,
    remat on, ama_fes, POD_ROUNDS rounds of each of ``runs`` through
    ``launch.train.pod_scale`` with --no-scan. Each run's counts are set
    to 0 just before it and read just after: the arch's kernels launched
    exactly as ``plan_launches`` derives from the staged schedule (on the
    tensor-core design for flash), server_mix once a round a dtype
    group, no other kernel and no plain version on the card; the
    runner's limited split as the schedule gives it; finite losses that
    start near ln(vocab) and fall; peak memory under 75 GB. Prints
    tokens/s over the whole run and over the rounds after the first (the
    runner's "round_dispatch" seconds, each closed by a CUDA sync) and
    the peak, then the all-limited pair side by side. Returns the counts
    summed over the runs."""
    spec = LLMS[arch]
    cfg = llm_full_width(arch)
    sp = kmods[0]
    per_round = POD_C * POD_STEPS * POD_B * POD_S
    totals, rows = {}, {}
    for label, plane, p_lim in runs:
        argv = [*pod_argv(arch), "--algorithm", "ama_fes", "--rounds",
                str(POD_ROUNDS), "--no-scan", "--client-plane", plane,
                "--p-limited", str(p_lim)]
        chunks = pod_chunks(train, argv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in kmods:
            m.reset_counts()
        designs = getattr(km, "design_launches", None)
        before = designs() if designs else None
        with CountPlain(ref, spec["plain"]) as plain_calls, \
                KeepRunner(train) as kept:
            state, metrics, dt = run_pod(torch, train, argv, cfg)
        peak = torch.cuda.max_memory_allocated()
        runner = kept.runners[-1]
        steady = runner.timer.summary()["round_dispatch"]
        counts = {k: fn.launches for m in kmods
                  for k, fn in m.KERNELS.items()}
        plain = dict(sp.plain_runs_on_cuda, **plain_calls.calls)
        params = tree_mod.leaves(state["params"])
        groups = len(tree_mod.dtype_groups(params))
        loss = metrics["loss"]
        want = plan_launches(arch, cfg, km, chunks, plane == "partitioned")
        want["server_mix"] = POD_ROUNDS * groups
        tok_s = POD_ROUNDS * per_round / dt
        steady_tok_s = steady["calls"] * per_round / steady["seconds"]
        n_lim = [int(x.sum()) for x in chunks]
        print(f"LLM client planes {arch} {label}: full width, "
              f"{cfg.num_layers} layers, remat on, --no-scan, limited "
              f"cohorts a round {n_lim}; {POD_ROUNDS} rounds in {dt:.3f} s "
              f"= {tok_s:,.0f} tokens/s (first-call set-up included), "
              f"{steady_tok_s:,.0f} tokens/s over rounds 2-{POD_ROUNDS}; "
              f"losses {[round(float(x), 4) for x in loss]}; peak device "
              f"memory {peak / 1e9:.2f} GB; limited split "
              f"{runner.limited_split}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; plain on the "
              f"card {sum(plain.values())}")
        got = {k: v for k, v in counts.items() if v}
        check(got == {k: v for k, v in want.items() if v},
              f"{arch} {label}: launches {got}, expected {want} from the "
              f"staged schedule {n_lim}")
        if designs:
            after = designs()
            moved = {k: {d: after[k][d] - before[k][d] for d in after[k]}
                     for k in after}
            check(all(moved[k] == {"cuda_cores": 0, "wgmma": want[k]}
                      for k in moved),
                  f"{arch} {label}: launches by design {moved}")
        if plane == "partitioned":
            check(runner.limited_split == limited_split_of(chunks),
                  f"{arch} {label}: limited split {runner.limited_split}, "
                  f"expected {limited_split_of(chunks)}")
        check(all(v == 0 for v in plain.values()),
              f"{arch} {label}: a plain version ran on the card: {plain}")
        check(all(math.isfinite(float(x)) for x in loss)
              and abs(float(loss[0]) - math.log(cfg.vocab_size)) < 1.0
              and float(loss[-1]) < float(loss[0]),
              f"{arch} {label}: losses {loss}")
        check(all(x.is_cuda and bool(torch.isfinite(x).all())
                  for x in params), f"{arch} {label}: non-finite or "
              "off-card params")
        check(peak < 75e9, f"{arch} {label}: peak device memory "
              f"{peak / 1e9:.2f} GB beyond 75 GB")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        rows[label] = dict(run=f"llm {arch} ama_fes {label}",
                           rounds=POD_ROUNDS, seconds=dt, tokens_per_s=tok_s,
                           steady_tokens_per_s=steady_tok_s, peak_bytes=peak,
                           losses=[float(x) for x in loss],
                           limited_per_round=n_lim,
                           params=sum(x.numel() for x in params),
                           limited_split=runner.limited_split,
                           launches={k: v for k, v in counts.items() if v})
        main_record.append(rows[label])
        del state, params
        torch.cuda.empty_cache()
    m, p = rows.get("masked p_limited 1.0"), rows.get(
        "partitioned p_limited 1.0")
    if m and p:
        print(f"client planes {arch}, every cohort limited: masked "
              f"{m['steady_tokens_per_s']:,.0f} tokens/s, peak "
              f"{m['peak_bytes'] / 1e9:.2f} GB; partitioned "
              f"{p['steady_tokens_per_s']:,.0f} tokens/s, peak "
              f"{p['peak_bytes'] / 1e9:.2f} GB (rounds 2-{POD_ROUNDS}; "
              f"{p['steady_tokens_per_s'] / m['steady_tokens_per_s']:.3f}x "
              "the tokens/s)")
    return totals


#: rwkv6_deep: the depth of its probe run and the peak memory its chosen
#: depth is predicted to stay within (the limit is 75 GB; the rest of the
#: 80 GB card is room for the caching allocator's unused blocks)
DEEP_PROBE_LAYERS, DEEP_TARGET = 16, 70e9


def rwkv6_deep(torch, train, rs, kmods, tree_mod, peak_at_8, main_record):
    """rwkv6-3b at full width as deep as one card holds with remat on,
    one round of ama_fes. The depth comes from a measurement: the peak of
    the 8-layer ama_fes run (``peak_at_8``) and of one round at
    DEEP_PROBE_LAYERS layers give the peak's growth a layer; the depth is
    the deepest of at most 32 layers whose straight-line prediction stays
    within DEEP_TARGET. The run at that depth checks the launches, a
    finite round-0 loss near ln(vocab), finite params and a peak under
    75 GB; it reports the depth, parameters, peak and tokens/s."""
    arch = "rwkv6-3b"
    base = llm_full_width(arch)
    argv = [*pod_argv(arch), "--algorithm", "ama_fes", "--rounds", "1"]
    tokens = POD_C * POD_STEPS * POD_B * POD_S

    def one_round(layers):
        cfg = base.with_(num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in kmods:
            m.reset_counts()
        state, metrics, dt = run_pod(torch, train, argv, cfg)
        return cfg, state, metrics, dt, torch.cuda.max_memory_allocated()

    probe = one_round(DEEP_PROBE_LAYERS)
    peak_probe = probe[-1]
    del probe
    slope = (peak_probe - peak_at_8) / (DEEP_PROBE_LAYERS - 8)
    fits = [n for n in range(9, 33)
            if peak_probe + (n - DEEP_PROBE_LAYERS) * slope <= DEEP_TARGET]
    check(bool(fits), f"rwkv6-3b: no depth past 8 is predicted within "
          f"{DEEP_TARGET / 1e9:.0f} GB (8 layers {peak_at_8 / 1e9:.2f} GB, "
          f"{DEEP_PROBE_LAYERS} layers {peak_probe / 1e9:.2f} GB)")
    depth = max(fits)
    predicted = peak_probe + (depth - DEEP_PROBE_LAYERS) * slope
    cfg, state, metrics, dt, peak = one_round(depth)
    params = tree_mod.leaves(state["params"])
    n_params = sum(x.numel() for x in params)
    groups = len(tree_mod.dtype_groups(params))
    loss = metrics["loss"]
    counts = {k: fn.launches for m in kmods for k, fn in m.KERNELS.items()}
    print(f"rwkv6-3b deep: peak {peak_at_8 / 1e9:.2f} GB at 8 layers, "
          f"{peak_probe / 1e9:.2f} GB at {DEEP_PROBE_LAYERS} (one round): "
          f"{slope / 1e9:.3f} GB a layer, so {depth} layers (the deepest "
          f"<= 32 predicted within {DEEP_TARGET / 1e9:.0f} GB: "
          f"{predicted / 1e9:.2f} GB); full width, remat on, {n_params:,} "
          f"params; 1 round in {dt:.3f} s = {tokens / dt:,.0f} tokens/s "
          f"(first-call set-up included); loss {float(loss[0]):.4f}; peak "
          f"device memory {peak / 1e9:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    check(depth > 8, f"rwkv6-3b deep: {depth} layers")
    check(peak < 75e9, f"rwkv6-3b at {depth} layers: peak device memory "
          f"{peak / 1e9:.2f} GB beyond 75 GB")
    check(all(math.isfinite(float(x)) for x in loss)
          and abs(float(loss[0]) - math.log(cfg.vocab_size)) < 1.0,
          f"rwkv6-3b at {depth} layers: round 0 loss {loss}")
    check(all(x.is_cuda and bool(torch.isfinite(x).all()) for x in params),
          f"rwkv6-3b at {depth} layers: non-finite or off-card params")
    want = plan_launches(arch, cfg, rs, pod_chunks(train, argv), False)
    want["server_mix"] = groups
    check({k: v for k, v in counts.items() if v} == want,
          f"rwkv6-3b at {depth} layers: launches {counts}, expected {want}")
    main_record.append(dict(run=f"llm {arch} ama_fes deep", rounds=1,
                            seconds=dt, tokens_per_s=tokens / dt,
                            remat=True, layers=depth, params=n_params,
                            peak_bytes=peak, predicted_peak_bytes=predicted,
                            probe_peak_bytes=peak_probe,
                            losses=[float(x) for x in loss]))
    del state, params
    torch.cuda.empty_cache()
    return counts


def llm_card_vs_cpu(torch, train, arch, km, tree_mod, plane="masked",
                    cfg=None, label=""):
    """The reduced LLM path in f32 (TF32 off), with the config's remat
    on, the same params (drawn on the CPU from the seed) and tokens: on
    the card through the kernels, on the CPU through the plain versions;
    params and losses within rtol 1e-4, atol 1e-5 after 2 rounds (one
    chunk) on the client ``plane``, the kernels' launches as
    ``plan_launches`` derives them from the staged schedule. ``cfg``
    overrides the reduced config (``label`` names the change)."""
    argv = [*reduced_pod(arch), "--rounds", "2", "--client-plane", plane]
    km.reset_counts()
    cfg = cfg or llm_reduced(arch)
    a, ma, _ = run_pod(torch, train, argv, cfg, "cuda")
    want = plan_launches(arch, cfg, km, pod_chunks(train, argv),
                         plane == "partitioned")
    for name, fn in km.KERNELS.items():
        check(fn.launches == want[name],
              f"reduced {arch} {plane} on the card: {name} launched "
              f"{fn.launches} times, expected {want[name]}")
    b, mb, _ = run_pod(torch, train, argv, cfg, "cpu")
    worst = 0.0
    for x, y in zip(tree_mod.leaves(a["params"]), tree_mod.leaves(b["params"]),
                    strict=True):
        worst = max(worst, float((x.cpu() - y).abs().max()))
        check(torch.allclose(x.cpu(), y, rtol=1e-4, atol=1e-5),
              f"reduced {arch}: card and CPU params differ by {worst:.3e}")
    check(all(abs(p - q) <= 1e-5 + 1e-4 * abs(q)
              for p, q in zip(ma["loss"], mb["loss"])),
          f"reduced {arch}: losses {ma['loss']} (card) vs {mb['loss']} "
          "(CPU)")
    print(f"reduced {arch}{label} f32, {plane} client plane, 2 rounds: card "
          f"({LLMS[arch]['trace']}* launches {want} + "
          f"server kernels) vs CPU (plain versions) max |diff| {worst:.3e} "
          f"(tolerance rtol 1e-4, atol 1e-5); losses {list(ma['loss'])} vs "
          f"{list(mb['loss'])}")


def llm_partitioned_contract(torch, train, arch, tree_mod, cfg=None):
    """chunked == per-round, bitwise, on the reduced LLM path on the
    card under the partitioned client plane: ama_fes, 3 rounds at
    p_limited 0.5 through one ``ChunkRunner`` chunk and through its
    per-round fallback, which replays the chunk's dispatch round by
    round (the launcher's --no-scan stages every round on its own, an
    exact split that is another program, so it is not the comparison).
    """
    from repro_torch import env as env_mod
    from repro_torch.core import strategies
    from repro_torch.core.round import init_state
    from repro_torch.models.api import build_model
    argv = [*reduced_pod(arch), "--rounds", "3", *PARTITIONED]
    args = train.parser().parse_args(argv)
    cfg = cfg or llm_reduced(arch)
    fl = train.fl_config(args).with_(clients_per_round=POD_C)
    model = build_model(cfg)
    sb = env_mod.resolve(fl.with_(num_clients=POD_C)).batch(0, 3)
    batch = train._pod_batch(cfg, fl, args)
    dev, out = torch.device("cuda"), []
    for use_scan in (True, False):
        state = init_state(model, fl, torch.Generator().manual_seed(fl.seed),
                           dev, strategies.resolve(fl))
        runner = train.ChunkRunner(model, fl, per_round_batch=False,
                                   use_scan=use_scan, device=dev)
        out.append((*runner.run_chunk(state, batch, dict(sb)),
                    runner.limited_split))
    (a, ma, split), (b, mb, _) = out
    check(all(torch.equal(x, y) for x, y in zip(
        tree_mod.leaves(a), tree_mod.leaves(b), strict=True)),
          f"reduced {arch} partitioned: chunked and per-round runs differ")
    check(list(ma["loss"]) == list(mb["loss"]),
          f"reduced {arch} partitioned: chunked and per-round losses differ")
    print(f"port contract: 3 rounds of the reduced {arch} path (ama_fes, "
          f"partitioned client plane, limited a round "
          f"{sb['limited'].sum(axis=1).tolist()}, split {split}) chunked == "
          "per round, bitwise, params and losses")


def llm_contract(torch, train, arch, tree_mod, cfg=None, label=""):
    """chunked == per-round (--no-scan), bitwise, on the reduced LLM path
    on the card: ama_fes, 3 rounds (``cfg`` overrides the reduced
    config)."""
    argv = [*reduced_pod(arch), "--rounds", "3"]
    cfg = cfg or llm_reduced(arch)
    a, ma, _ = run_pod(torch, train, argv, cfg)
    b, mb, _ = run_pod(torch, train, argv + ["--no-scan"], cfg)
    check(all(torch.equal(x, y) for x, y in zip(
        tree_mod.leaves(a), tree_mod.leaves(b), strict=True)),
          f"reduced {arch}: chunked and per-round runs differ")
    check(list(ma["loss"]) == list(mb["loss"]),
          f"reduced {arch}: chunked and per-round losses differ")
    print(f"port contract: 3 rounds of the reduced {arch}{label} path "
          "(ama_fes) chunked == per round (--no-scan), bitwise, params and "
          "losses")


def device_ms_by_range(events, names, only=None) -> dict:
    """{name: (ms, launches)}: the device time (kernels, copies, sets; with
    ``only``, the kernels whose name matches that pattern) of
    a Chrome trace's ``events`` launched inside the profiler ranges
    ``names`` (``obs.timing.annotate``) or by the backward of an op
    recorded inside one: each such op's ``fwdbwd`` flow ends at the
    backward function it made (``autograd::engine::evaluate_function``),
    whose span, on the thread that ran it, counts for the range. A
    launch belongs to the span around its runtime call (same thread,
    the call's start inside the span; the spans of one thread do not
    overlap)."""
    spans: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            spans.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))

    def find(tid, ts, among):
        for a, b, n in among.get(tid, ()):
            if a <= ts <= b:
                return n
        return None
    ops = {(e["tid"], e["ts"]): e for e in events if e.get("cat") == "cpu_op"}
    flows = [e for e in events if e.get("cat") == "fwdbwd"]
    starts = {e["id"]: e for e in flows if e["ph"] == "s"}
    fwd = {tid: list(v) for tid, v in spans.items()}
    for e in flows:
        s = starts.get(e["id"]) if e["ph"] == "f" else None
        op = s and ops.get((e["tid"], e["ts"]))
        name = op and find(s["tid"], s["ts"], fwd)
        if name:
            spans.setdefault(e["tid"], []).append(
                (op["ts"], op["ts"] + op["dur"], name))
    for v in spans.values():
        v.sort()
    starts_of = {tid: [a for a, _, _ in v] for tid, v in spans.items()}
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {n: (0.0, 0) for n in names}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if only and not re.search(only, e.get("name", "")):
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is None or at[0] not in spans:
            continue
        i = bisect.bisect_right(starts_of[at[0]], at[1]) - 1
        if i >= 0 and at[1] <= spans[at[0]][i][1]:
            ms, n = out[spans[at[0]][i][2]]
            out[spans[at[0]][i][2]] = (ms + float(e.get("dur", 0.0)) / 1e3,
                                       n + 1)
    return out


def llm_where_time_goes(torch, train, arch, tmp, extra=(), ranges=(),
                        only=None):
    """2 full-width rounds of ``arch`` (the config's remat on; ``extra``
    launcher arguments) under the launcher's --profile: device time by
    kernel from the Chrome trace, the arch's kernels' share of it, each
    kernel's passes, and the device's idle share of the training wall
    time; with ``ranges``, the device time of each of those profiler
    ranges (``device_ms_by_range``) under the key "ranges", and with
    ``only`` that of the kernels matching it there, under
    "ranges_only"."""
    trace_dir = str(Path(tmp) / f"profile_{arch}{len(extra)}")
    argv = [*pod_argv(arch), "--algorithm", "ama_fes", "--rounds", "2",
            "--profile", trace_dir, *extra]
    _, _, dt = run_pod(torch, train, argv, llm_full_width(arch))
    with open(Path(trace_dir) / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    busy = sum(us for _, us in by_name.values()) / 1e3
    check(busy > 0, f"{arch} profile: the trace holds no device time")
    tag = LLMS[arch]["trace"]
    own = sum(us for k, (_, us) in by_name.items() if tag in k) / 1e3
    print(f"where the time goes, {arch} full width, 2 rounds"
          f"{' ' + ' '.join(extra) if extra else ''}: "
          f"{dt * 1e3:.1f} ms training wall under the profiler, device busy "
          f"{busy:.1f} ms = {busy / (dt * 1e3):.1%} (idle "
          f"{1 - busy / (dt * 1e3):.1%}); {tag}* kernels {own:.1f} ms = "
          f"{own / busy:.1%} of device time")
    pats = LLMS[arch].get("part_kernels", {})
    for part in LLMS[arch]["parts"]:   # a kernel wrapper's launches
        pat = pats.get(part, re.escape(part))
        of = {k: v for k, v in by_name.items() if re.search(pat, k)}
        n = sum(c for c, _ in of.values())
        ms = sum(us for _, us in of.values()) / 1e3
        print(f"  {part}: {ms:.1f} ms in {n} launches = {ms / busy:.1%} of "
              "device time")
        for k, (c, us) in sorted(of.items()):   # its passes
            m = re.search(r"\w+_kernel(<[^>]*>)?", k)
            if m:
                print(f"    {m.group(0)}: {us / 1e3:.1f} ms in {c} launches "
                      f"({us / 1e3 / c:.4f} ms each) = "
                      f"{us / 1e3 / busy:.1%}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:100]}")
    return dict(wall_ms=dt * 1e3, busy_ms=busy, own_ms=own,
                ranges=device_ms_by_range(events, ranges) if ranges else {},
                ranges_only=device_ms_by_range(events, ranges, only)
                if ranges and only else {})


# ------------------------------------------------ the moe family (A1) -----

#: the reduced moe path's blocked dispatch: groups of 32 of a cohort's
#: 2 x 64 tokens (the launcher's --batch and --seq defaults)
MOE_BLOCK = 32
#: mixtral's reduced window (64) cut so that it bites at S 64
MIXTRAL_WINDOW = 16


def moe_pod_path(torch, train, km, kmods, ref, tree_mod, main_record):
    """phi3.5-moe at full width, 2 of its 32 layers (one body, one tail
    block: 2,863,288,320 parameters, two dtype groups, the bf16 weights
    and the f32 routers), remat on, masked client plane, ama_fes, 3
    rounds of 2 cohorts x 2 local steps x 1 x 2048 tokens with --no-scan
    through ``pod_client_planes``: the flash kernels' launches from
    ``plan_launches`` (all on wgmma), server_mix once a round for each of
    the 2 groups, no other kernel and no plain version on the card,
    losses near ln(vocab) that fall, tokens/s over rounds 2-3, peak
    memory under 75 GB. Returns the counts."""
    from repro_torch.models.moe import _capacity
    cfg = llm_full_width(PHI)
    counts = pod_client_planes(torch, train, PHI, km, kmods, ref, tree_mod,
                               main_record,
                               runs=[("masked p_limited 0.5", "masked", 0.5)])
    check(counts["server_mix"] == 2 * POD_ROUNDS,
          f"phi3.5-moe: server_mix launched {counts['server_mix']} times, "
          f"expected 2 a round (the bf16 group and the f32 routers)")
    row = main_record[-1]
    check(row["params"] == LLMS[PHI]["params"], f"phi3.5-moe: "
          f"{row['params']} params, expected {LLMS[PHI]['params']}")
    print(f"phi3.5-moe pod path: full width, {cfg.num_layers} layers "
          f"({cfg.num_experts} experts, top {cfg.top_k}, a cohort's "
          f"{POD_B * POD_S} tokens dispatched in one group of capacity "
          f"{_capacity(POD_B * POD_S, cfg)}), "
          f"{LLMS[PHI]['params']:,} params; peak {row['peak_bytes'] / 1e9:.2f} "
          f"GB (limit 75); {row['steady_tokens_per_s']:,.0f} tokens/s over "
          f"rounds 2-{POD_ROUNDS}; server_mix {counts['server_mix']} "
          f"launches (2 dtype groups x {POD_ROUNDS} rounds)")
    return counts


def moe_reduced_on_card(torch, train, fa, tree_mod):
    """The reduced moe and large dense configs in f32 on the card against
    the CPU (rtol 1e-4, atol 1e-5) and chunked == per round bitwise:
    phi3.5-moe through the global dispatch (a cohort's 128 tokens in one
    group) and the blocked one (groups of MOE_BLOCK), mixtral with its
    window cut to MIXTRAL_WINDOW, qwen with its qkv bias, and phi3.5-moe
    on the partitioned client plane."""
    blocked = llm_reduced(PHI).with_(moe_group_size=MOE_BLOCK)
    mixtral = llm_reduced("mixtral-8x22b").with_(
        sliding_window=MIXTRAL_WINDOW)
    runs = [(PHI, None, " (global dispatch)"),
            (PHI, blocked, f" (blocked dispatch, groups of {MOE_BLOCK})"),
            ("mixtral-8x22b", mixtral, f" (window {MIXTRAL_WINDOW})"),
            ("qwen1.5-110b", None, " (qkv bias)")]
    for arch, cfg, label in runs:
        llm_card_vs_cpu(torch, train, arch, fa, tree_mod, "masked", cfg,
                        label)
        llm_contract(torch, train, arch, tree_mod, cfg, label)
    llm_card_vs_cpu(torch, train, PHI, fa, tree_mod, "partitioned")
    llm_partitioned_contract(torch, train, PHI, tree_mod)


def moe_where_time_goes(torch, train, fa, tmp):
    """2 full-width rounds of phi3.5-moe under the launcher's --profile
    (``llm_where_time_goes``: device busy and idle, the flash kernels'
    share, the top kernels) and, from the same trace, the device time of
    its MoE layers' parts (``device_ms_by_range`` over ``moe_apply``'s
    profiler ranges, each with its backward): the routing and dispatch
    product, the experts' GEMMs, the combine product. Checks that each
    part launched work on the card."""
    from repro_torch.models import moe
    parts = {moe.DISPATCH: "dispatch", moe.EXPERTS: "experts' GEMMs",
             moe.COMBINE: "combine"}
    prof = llm_where_time_goes(torch, train, PHI, tmp, ranges=tuple(parts))
    busy = prof["busy_ms"]
    for key, label in parts.items():
        ms, n = prof["ranges"][key]
        check(n > 0, f"phi3.5-moe profile: no device work in the {key} "
              "range")
        print(f"  phi3.5-moe {label} ({key} and its backward): {ms:.1f} ms "
              f"in {n} launches = {ms / busy:.1%} of device time")
    share = {label: prof["ranges"][key][0] / busy
             for key, label in parts.items()}
    print(f"where the time goes, phi3.5-moe full width, 2 rounds (trace): "
          f"flash {prof['own_ms'] / busy:.1%}, "
          + ", ".join(f"{k} {v:.1%}" for k, v in share.items())
          + f" of device time; idle {1 - busy / prof['wall_ms']:.1%}")
    return share


# ----------------------------------------------- the hybrid family (A1) --

#: the reduced zamba2 of phases 5-6: 6 layers, a body of 5 blocks (2
#: shared-attention sites at reduced attn_every 2, and a remainder) and a
#: tail of 1 (at reduced()'s 2 layers the body is shorter than attn_every
#: and the shared attention never runs)
ZAMBA_REDUCED_LAYERS = 6


def zamba2_pod_path(torch, train, km, kmods, ref, tree_mod, main_record):
    """zamba2-1.2b at full width and all 38 layers (36 body blocks with 6
    shared-attention sites, 2 tail blocks; 1,119,979,648 parameters in
    two dtype groups, bf16 and the blocks' f32 A_log, D, dt_bias), remat
    on, 3 rounds of 2 cohorts x 2 local steps x 1 x 2048 tokens: ama_fes
    and fedavg through ``pod_main_path`` (``km`` the mamba2 and flash
    kernels: launches from ``plan_launches``, flash all on wgmma,
    server_mix once a round for each of the 2 groups, no plain version on
    the card), then ama_fes on the masked plane with --no-scan through
    ``pod_client_planes`` for tokens/s over rounds 2-3. Returns the
    counts summed over the runs."""
    import numpy as np
    cfg = llm_full_width(ZAMBA)
    counts, (_, _, peak) = pod_main_path(torch, train, ZAMBA, km, kmods,
                                         ref, tree_mod, main_record)
    more = pod_client_planes(torch, train, ZAMBA, km, kmods, ref, tree_mod,
                             main_record,
                             runs=[("masked p_limited 0.5", "masked", 0.5)])
    row = main_record[-1]
    check(row["params"] == ZAMBA_N, f"zamba2: {row['params']} params, "
          f"expected {ZAMBA_N}")
    check(more["server_mix"] == 2 * POD_ROUNDS, f"zamba2: server_mix "
          f"launched {more['server_mix']} times, expected 2 a round")
    a_round = plan_launches(ZAMBA, cfg, km, [np.zeros((1, POD_C), bool)],
                            False)
    print(f"zamba2 pod path: full width (d {cfg.d_model}, {cfg.num_layers} "
          f"layers, {cfg.num_layers - cfg.fes_tail_layers} body blocks, "
          f"{(cfg.num_layers - cfg.fes_tail_layers) // cfg.attn_every} "
          f"shared-attention sites, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, state {cfg.ssm_state}), {ZAMBA_N:,} params; "
          f"peak {peak / 1e9:.2f} GB (limit 75); "
          f"{row['steady_tokens_per_s']:,.0f} tokens/s over rounds "
          f"2-{POD_ROUNDS} (masked, --no-scan), peak there "
          f"{row['peak_bytes'] / 1e9:.2f} GB; launches a round {a_round} "
          f"(the plan) and server_mix 2 (2 dtype groups)")
    return {k: counts.get(k, 0) + more.get(k, 0)
            for k in set(counts) | set(more)}


def zamba2_reduced():
    return llm_reduced(ZAMBA).with_(num_layers=ZAMBA_REDUCED_LAYERS)


def remat_contract(torch, train, arch, km, tree_mod, cfg):
    """Remat on == off on the card, bitwise: 2 rounds of the reduced path
    in f32 (ama_fes, masked) with each block under ``_BlockRemat`` and
    without; the forward kernels of the remat blocks twice a layer a
    step with remat, once without."""
    argv = [*reduced_pod(arch), "--rounds", "2"]
    out = []
    for on in (True, False):
        km.reset_counts()
        c = cfg.with_(remat=on)
        state, metrics, _ = run_pod(torch, train, argv, c)
        want = plan_launches(arch, c, km, pod_chunks(train, argv), False)
        got = {k: fn.launches for k, fn in km.KERNELS.items()}
        check(got == want, f"reduced {arch} remat {on}: launches {got}, "
              f"expected {want}")
        out.append((state, list(metrics["loss"])))
    (a, la), (b, lb) = out
    same = all(torch.equal(x, y) for x, y in zip(
        tree_mod.leaves(a["params"]), tree_mod.leaves(b["params"]),
        strict=True)) and la == lb
    check(same, f"reduced {arch}: remat on and off differ")
    print(f"port contract: 2 rounds of the reduced {arch} path (f32, "
          f"{cfg.num_layers} layers) with remat on == off, bitwise, params "
          "and losses")


def zamba2_reduced_on_card(torch, train, km, tree_mod):
    """The reduced zamba2 at 6 layers in f32 on the card against the CPU
    (rtol 1e-4, atol 1e-5) on the masked and partitioned client planes,
    chunked == per round and remat on == off, bitwise."""
    cfg = zamba2_reduced()
    label = (f" ({cfg.num_layers} layers, "
             f"{(cfg.num_layers - cfg.fes_tail_layers) // cfg.attn_every} "
             "shared-attention sites)")
    for plane in ("masked", "partitioned"):
        llm_card_vs_cpu(torch, train, ZAMBA, km, tree_mod, plane, cfg, label)
    llm_contract(torch, train, ZAMBA, tree_mod, cfg, label)
    remat_contract(torch, train, ZAMBA, km, tree_mod, cfg)


def zamba2_where_time_goes(torch, train, tmp):
    """2 full-width rounds of zamba2 under the launcher's --profile
    (``llm_where_time_goes``: device busy and idle, the mamba2 kernels'
    share and that of each kernel and of flash, the top kernels) and,
    from the same trace, the device time of the recurrence's profiler
    range (``mamba2_scan``: its kernels, forward and backward) and of the
    shared-attention sites (``shared_attention``: the norm, the
    projections and flash, with their backward). Returns the shares."""
    from repro_torch.models import mamba2, transformer
    ranges = {mamba2.SCAN: "the recurrence",
              transformer.SHARED_ATTN: "the shared attention"}
    prof = llm_where_time_goes(torch, train, ZAMBA, tmp,
                               ranges=tuple(ranges))
    busy = prof["busy_ms"]
    for key, label in ranges.items():
        ms, n = prof["ranges"][key]
        check(n > 0, f"zamba2 profile: no device work in the {key} range")
        print(f"  zamba2 {label} ({key} and its backward): {ms:.1f} ms in "
              f"{n} launches = {ms / busy:.1%} of device time")
    share = {label: prof["ranges"][key][0] / busy
             for key, label in ranges.items()}
    print(f"where the time goes, zamba2 full width, 2 rounds (trace): busy "
          f"{busy / prof['wall_ms']:.1%} of the wall; mamba2 kernels "
          f"{prof['own_ms'] / busy:.1%}, "
          + ", ".join(f"{k} {v:.1%}" for k, v in share.items())
          + " of device time")
    return share


# ------------------------------------ the vlm and encoder-decoder (A1) ---

#: the reduced whisper's frames: 100 (a ragged flash tile, and q of 64
#: tokens against k, v of 100 frames in the cross-attention)
WHISPER_REDUCED_FRAMES = 100


def slice20_pod_paths(torch, train, km, kmods, ref, tree_mod,
                      main_record) -> dict:
    """phi-3-vision-4.2b (24 of 32 layers, 2,918,206,464 parameters:
    LLMS says why) and whisper-medium (all 24 + 24 layers, 812,523,520)
    at full width, remat
    on, 3 rounds of 2 cohorts x 2 local steps x 1 x 2,048 tokens (the
    vlm's 576 patch rows before them, N(0, 1) from the seed, whisper's
    1,500 frames beside them, zeros, as the launcher's pod batch has
    them): ama_fes and fedavg on
    the masked plane through ``pod_main_path`` (``km`` the flash
    kernels: launches from ``plan_launches``, all on wgmma, server_mix
    once a round, no plain version on the card, the depth, parameters
    and peak printed; whisper also ama_fes with remat off, bitwise), then
    ama_fes on the partitioned plane at p_limited 0.5 with --no-scan
    (``pod_client_planes``) beside the masked run. Returns the counts
    summed over the runs."""
    from repro_torch.configs.registry import get_arch
    totals = {}
    for arch in (VLM, WHISPER):
        cfg = llm_full_width(arch)
        counts, (_, _, peak) = pod_main_path(torch, train, arch, km,
                                             kmods, ref, tree_mod,
                                             main_record)
        masked = next(r for r in main_record
                      if r["run"] == f"llm {arch} ama_fes")
        more = pod_client_planes(torch, train, arch, km, kmods, ref,
                                 tree_mod, main_record,
                                 runs=POD_PLANE_RUNS[:1])
        part = main_record[-1]
        check(masked["params"] == LLMS[arch]["params"],
              f"{arch}: {masked['params']} params, expected "
              f"{LLMS[arch]['params']}")
        print(f"{arch} pod path: full width (d {cfg.d_model}, "
              f"{cfg.num_layers} of {get_arch(arch).num_layers} decoder "
              "layers"
              + (f" + {cfg.encoder_layers} encoder layers over "
                 f"{cfg.encoder_seq} frames" if cfg.encoder_layers else
                 f", {cfg.num_patches} patches of {cfg.vision_dim}")
              + f", {cfg.num_heads} heads of {cfg.head_dim}), "
              f"{masked['params']:,} params; masked ama_fes "
              f"{masked['tokens_per_s']:,.0f} tokens/s, peak "
              f"{masked['peak_bytes'] / 1e9:.2f} GB; partitioned p_limited "
              f"0.5 {part['steady_tokens_per_s']:,.0f} tokens/s over rounds "
              f"2-{POD_ROUNDS}, peak {part['peak_bytes'] / 1e9:.2f} GB "
              "(limit 75)")
        for k in set(counts) | set(more):
            totals[k] = totals.get(k, 0) + counts.get(k, 0) + more.get(k, 0)
    return totals


def whisper_reduced():
    return llm_reduced(WHISPER).with_(encoder_seq=WHISPER_REDUCED_FRAMES)


def slice20_reduced_on_card(torch, train, km, tree_mod):
    """The reduced phi-3-vision (16 patches + 64 tokens) and whisper (100
    frames, 64 tokens) in f32 on the card against the CPU (rtol 1e-4,
    atol 1e-5) on the masked and partitioned client planes; chunked ==
    per round and remat on == off, bitwise."""
    for arch, cfg in ((VLM, llm_reduced(VLM)), (WHISPER, whisper_reduced())):
        label = (f" ({cfg.encoder_seq} frames)" if cfg.encoder_layers else
                 f" ({cfg.num_patches} patches)")
        for plane in ("masked", "partitioned"):
            llm_card_vs_cpu(torch, train, arch, km, tree_mod, plane, cfg,
                            label)
        llm_contract(torch, train, arch, tree_mod, cfg, label)
        remat_contract(torch, train, arch, km, tree_mod, cfg)


def whisper_where_time_goes(torch, train, tmp) -> dict:
    """2 full-width rounds of whisper-medium under the launcher's
    --profile (``llm_where_time_goes``: device busy and idle, the flash
    kernels' share, the top kernels) and, from the same trace, the device
    time of its three kinds of attention (``encdec``'s profiler ranges:
    the encoder's, the decoder's self-attention and its cross-attention,
    each with its backward): all their kernels, and the flash kernels
    alone. Returns the flash kernels' share of device time by range."""
    from repro_torch.models import encdec
    ranges = {encdec.ENC_ATTN: "the encoder's attention",
              encdec.DEC_ATTN: "the decoder's self-attention",
              encdec.CROSS_ATTN: "the cross-attention"}
    prof = llm_where_time_goes(torch, train, WHISPER, tmp,
                               ranges=tuple(ranges), only=r"flash_")
    busy = prof["busy_ms"]
    share = {}
    for key, label in ranges.items():
        ms, n = prof["ranges"][key]
        fms, fn = prof["ranges_only"][key]
        check(fn > 0, f"whisper profile: no flash kernel in the {key} range")
        share[label] = fms / busy
        print(f"  whisper {label} ({key} and its backward): {ms:.1f} ms in "
              f"{n} launches = {ms / busy:.1%} of device time; its flash "
              f"kernels {fms:.1f} ms in {fn} launches = {fms / busy:.1%}")
    print(f"where the time goes, whisper full width, 2 rounds (trace): busy "
          f"{busy / prof['wall_ms']:.1%} of the wall; flash "
          f"{prof['own_ms'] / busy:.1%} of device time: "
          + ", ".join(f"{k} {v:.1%}" for k, v in share.items()))
    return share


# ------------------------------------------------------- serving (A5) -----

#: the serving runs at full width: minitron-8b's CONFIG_SWA (window 4096)
#: at all 32 layers, paged over more requests than slots (two prompts of
#: 4,000 tokens that carry the ring past 4,096, four of 512, four of 128,
#: 128 new tokens each) and the loop engine per token and chunked over 4
#: requests of 64-300 tokens; rwkv6-3b at 8 layers per token
SERVE_DEPTH = {"minitron-8b": 32, "rwkv6-3b": 8,
               # slice 17: the depths whose bf16 weights take 31-35 GB
               PHI: 12, "mixtral-8x22b": 6, "mistral-large-123b": 12,
               "qwen1.5-110b": 11, "llama3-405b": 4,
               # slice 18: all 38 layers (2.24 GB of bf16 weights)
               ZAMBA: 38,
               # slice 20: all 32 layers (7.65 GB) and all 24 + 24
               # (1.63 GB)
               VLM: 32, WHISPER: 24}
#: slice 17's configs at full width, depth cut as SERVE_DEPTH says: the
#: paged engine over two prompts of 200 tokens and two of 64, 16 new each;
#: the moe pair also through the loop engine per token, chunked 64 and
#: paged over three requests (SERVE_FAMILY_LOOP_MIX)
SERVE_FAMILIES = (PHI, "mixtral-8x22b", "mistral-large-123b",
                  "qwen1.5-110b", "llama3-405b")
SERVE_FAMILY_RUN = ["--engine", "paged", "--prompt-mix", "200x2,64x2",
                    "--tokens", "16", "--max-slots", "4", "--block-size",
                    "16", "--prefill-chunk", "64"]
SERVE_FAMILY_LOOP_MIX = ["--prompt-mix", "24x1,40x1,70x1", "--tokens", "8"]
SERVE_PAGED_RUN = ["--engine", "paged", "--prompt-mix",
                   "4000x2,512x4,128x4", "--tokens", "128", "--max-slots",
                   "4", "--block-size", "16", "--prefill-chunk", "64"]
SERVE_LOOP_MIX = ["--prompt-mix", "64x1,128x1,200x1,300x1", "--tokens", "32"]
SERVE_LOOP_RUNS = [("loop per token", ["--engine", "loop",
                                       "--prefill-chunk", "0"]),
                   ("loop chunked 64", ["--engine", "loop",
                                        "--prefill-chunk", "64"]),
                   ("paged", ["--engine", "paged", "--block-size", "16",
                              "--prefill-chunk", "64"])]
SERVE_RWKV_RUN = ["--engine", "loop", "--prompt-mix",
                  "64x1,128x1,192x1,256x1", "--tokens", "64",
                  "--prefill-chunk", "0"]
#: zamba2 at all 38 layers through the loop engine, per token (its only
#: serving path): two prompts of 64 tokens and two of 128, 32 new each
SERVE_ZAMBA_RUN = ["--engine", "loop", "--prompt-mix", "64x2,128x2",
                   "--tokens", "32", "--prefill-chunk", "0"]
SERVE_STEPS = ("decode_step", "prefill", "decode_step_paged",
               "prefill_paged")


class CountSteps:
    """Counts the calls of the transformer's serving steps while
    installed (the model API looks them up at call time)."""

    def __init__(self, tf):
        self.tf, self.calls = tf, dict.fromkeys(SERVE_STEPS, 0)
        self.real = {n: getattr(tf, n) for n in SERVE_STEPS
                     if hasattr(tf, n)}

    def __enter__(self):
        for n, real in self.real.items():
            def counted(*a, _n=n, _real=real, **kw):
                self.calls[_n] += 1
                return _real(*a, **kw)
            setattr(self.tf, n, counted)
        return self

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(self.tf, n, real)


def serve_config(arch, layers=None):
    """The arch's serving config at its published widths, depth cut to
    ``layers`` (SERVE_DEPTH by default)."""
    from repro_torch.configs.registry import serving_config
    n = layers or SERVE_DEPTH[arch]
    return serving_config(arch).with_(num_layers=n,
                                      fes_tail_layers=min(2, n))


def serve_params(torch, cfg, seed=0):
    from repro_torch.models.api import build_model
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(
        seed), dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def dense_launches(cfg) -> int:
    """invariant_dense launches a layer of a serving step: the attention's
    wq|wk|wv and wo, then the MLP's w_in|w_gate and w_out, or a moe
    block's router, its experts' w_in|w_gate pairs (two experts a launch)
    and each expert's w_out."""
    if not cfg.num_experts:
        return 4
    from repro_torch.kernels.invariant_dense import MAX_GROUP
    E = cfg.num_experts
    return 2 + 1 + -(-E // (MAX_GROUP // 2)) + E


def decode_bound_ms(cfg, params, tree_mod, slots: int) -> float:
    """The least time of one decode step at ``slots`` requests: every
    weight read once (the embedding table only at the slots' rows); for
    the encoder-decoder the decoder's weights and every layer's cross
    K/V of each slot (the encoder ran once, when the cache was made)."""
    if cfg.family == "audio":
        params = {k: v for k, v in params.items()
                  if k not in ("enc_pos", "encoder", "enc_norm")}
    leaves = tree_mod.leaves(params)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    emb = params["embed"]["table"]
    nbytes -= emb.numel() * emb.element_size()
    nbytes += slots * cfg.d_model * emb.element_size()
    if cfg.family == "audio":
        nbytes += (2 * slots * cfg.num_layers * cfg.encoder_seq
                   * cfg.num_kv_heads * cfg.resolved_head_dim
                   * emb.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def serve_run(torch, serve_mod, tf, kmods, ref, cfg, params, argv, label,
              main_record, tree_mod):
    """One serving run through ``launch.serve.serve`` on the card, the
    counts set to 0 just before it and read just after: for the dense
    and moe families serve_attention launched layers x serving steps,
    invariant_dense (``dense_launches`` x layers + 1) x steps (dense: 4 a
    layer, wq|wk|wv and w_in|w_gate one launch each; moe: 3 + 3 E / 2),
    invariant_add_rmsnorm 2 layers x steps and
    invariant_rmsnorm 1 x steps (the first block's norm); for the
    encoder-decoder (audio) family serve_attention and its cross form
    layers x steps, invariant_dense (6 x layers + 1) x steps (wq|wk|wv,
    wo, the cross-attention's wq and wo, w_in, w_out; lm_head),
    invariant_add_rmsnorm 3 layers x steps, invariant_rmsnorm 1 x steps
    and flash_fwd once an encoder layer (the frames encoded once, when
    the engine makes its cache); for the ssm
    family rwkv6_fwd layers x decode steps; for the hybrid family
    mamba2_fwd layers x decode steps, and serve_attention once and
    invariant_dense twice (wq|wk|wv, wo) a shared-attention site a step;
    no other kernel, no plain version on the card;
    every request served its tokens. Prints tokens/s, latency percentiles,
    the mean prefill and decode seconds a request and the peak device
    memory. Returns (results, engine, counts)."""
    args = serve_mod.parser().parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in kmods:
        m.reset_counts()
    with CountPlain(ref, ("serve_attention_ref", "rwkv6_scan_ref",
                          "mamba2_scan_ref", "invariant_dense_ref",
                          "invariant_rmsnorm_ref",
                          "invariant_add_rmsnorm_ref",
                          "serve_cross_attention_ref",
                          "flash_attention_ref")) \
            as plain, CountSteps(tf) as steps:
        results, summary, dt, engine = serve_mod.serve(
            args, cfg, torch.device("cuda"), params)
    peak = torch.cuda.max_memory_allocated()
    counts = {k: fn.launches for m in kmods for k, fn in m.KERNELS.items()}
    calls = sum(steps.calls.values())
    L = cfg.num_layers
    decode = steps.calls["decode_step"]
    sites = (L - min(cfg.fes_tail_layers, L)) // max(cfg.attn_every, 1)
    if cfg.family == "ssm":
        want = {"rwkv6_fwd": L * decode}
    elif cfg.family == "hybrid":
        want = {"mamba2_fwd": L * decode, "serve_attention": sites * decode,
                "invariant_dense": 2 * sites * decode}
    elif cfg.family == "audio":
        want = {"serve_attention": L * calls,
                "serve_cross_attention": L * calls,
                "invariant_dense": (6 * L + 1) * calls,
                "invariant_add_rmsnorm": 3 * L * calls,
                "invariant_rmsnorm": calls,
                "flash_fwd": cfg.encoder_layers}
    else:
        want = {"serve_attention": L * calls,
                "invariant_dense": (dense_launches(cfg) * L + 1) * calls,
                "invariant_add_rmsnorm": 2 * L * calls,
                "invariant_rmsnorm": calls}
    new = sum(r["new_tokens"] for r in results)
    mean = lambda k: statistics.mean(r[k] for r in results)
    bound = decode_bound_ms(cfg, params, tree_mod, len(results)
                            if args.engine == "loop" else args.max_slots)
    print(f"serving {cfg.name} {label}: {cfg.num_layers} layers, "
          f"{len(results)} requests, {new} new tokens in {dt:.3f} s = "
          f"{summary['tokens_per_s']} tokens/s; p50/p95/p99 "
          f"{summary['p50_ms']}/{summary['p95_ms']}/{summary['p99_ms']} ms; "
          f"a request's prefill {mean('prefill_s'):.3f} s, decode "
          f"{mean('decode_s'):.3f} s; steps {steps.calls}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; peak device memory "
          f"{peak / 1e9:.2f} GB; decode bound {bound:.3f} ms a step (the "
          f"weights once)")
    for kern, n in want.items():
        check(counts[kern] == n, f"serving {label}: {kern} launched "
              f"{counts[kern]} times, expected {n} ({L} layers x "
              f"{steps.calls})")
    check(calls > 0, f"serving {label}: no serving step ran")
    others = {k: v for k, v in counts.items() if k not in want and v}
    check(not others, f"serving {label}: other kernels launched: {others}")
    check(sum(plain.calls.values()) == 0,
          f"serving {label}: a plain version ran on the card: {plain.calls}")
    reqs = serve_mod.requests_of(args, cfg.vocab_size)
    for r, q in zip(results, reqs, strict=True):
        check(r["new_tokens"] == q.max_new and all(
            0 <= t < cfg.vocab_size for t in r["tokens"]),
            f"serving {label}: request {r['id']} served "
            f"{r['new_tokens']} of {q.max_new} tokens, or an id off the "
            "vocabulary")
    check(peak < 75e9, f"serving {label}: peak device memory "
          f"{peak / 1e9:.2f} GB beyond 75 GB")
    main_record.append(dict(run=f"serve {cfg.name} {label}",
                            layers=cfg.num_layers, seconds=dt,
                            tokens_per_s=summary["tokens_per_s"],
                            p50_ms=summary["p50_ms"],
                            p95_ms=summary["p95_ms"],
                            p99_ms=summary["p99_ms"],
                            prefill_s=mean("prefill_s"),
                            decode_s=mean("decode_s"), steps=steps.calls,
                            peak_bytes=peak, decode_bound_ms=bound))
    return results, engine, counts


def serve_where_time_goes(torch, serve_mod, cfg, params):
    """The paged engine over 4 prompts of 128 tokens, 17 new (two prefill
    chunks of 4 x 64 rows, then one burst of 16 decode steps) under the
    launcher's --profile: device time by kernel from the Chrome trace,
    the shares of serve_attention and the row-invariant GEMM and norm, the
    device's idle share of the wall."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--engine", "paged", "--prompt-mix", "128x4", "--tokens",
                "17", "--block-size", "16", "--prefill-chunk", "64",
                "--profile", tmp]
        _, _, dt, _ = serve_mod.serve(serve_mod.parser().parse_args(argv),
                                      cfg, torch.device("cuda"), params)
        with open(Path(tmp) / "trace.json") as f:
            events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    busy = sum(us for _, us in by_name.values()) / 1e3
    check(busy > 0, "serving profile: the trace holds no device time")
    shares = []
    for kern in ("serve_attention", "invariant_dense", "invariant_rmsnorm"):
        own = [(n, us) for k, (n, us) in by_name.items() if kern in k]
        ms = sum(us for _, us in own) / 1e3
        shares.append(f"{kern} {ms:.1f} ms in {sum(n for n, _ in own)} "
                      f"launches = {ms / busy:.1%}")
    print(f"where the time goes, serving {cfg.name} ({cfg.num_layers} "
          f"layers) paged, 2 prefill chunks + 16 decode steps: {dt * 1e3:.1f} "
          f"ms wall under the profiler, device busy {busy:.1f} ms = "
          f"{busy / (dt * 1e3):.1%} (idle {1 - busy / (dt * 1e3):.1%}); "
          + ", ".join(shares) + " of device time")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:100]}")


#: the kernels a decode step's norm sites may launch: the row-invariant
#: norm (both forms) and PyTorch's elementwise add (the residual adds,
#: beside the step's other adds)
NORM_SITE_KERNELS = {"norm": "invariant_rmsnorm", "add": "CUDAFunctor_add"}


def decode_step_profile(torch, cfg, params, slots=4, bs=16) -> dict:
    """The device kernels of ONE decode step of ``cfg``'s dense model
    (``decode_step_paged`` over ``slots`` requests at position 0, each
    with one block of ``bs`` slots), from a torch.profiler trace of the
    step (``device_events``): how many, their device time, and the
    launches and time of the norm sites' kernels (NORM_SITE_KERNELS); the
    kernels by name are printed. Uses only what every checkout of the
    port has, so scripts/phase3_ab.py runs it against another checkout
    (check ``decode_step``)."""
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    dev = torch.device("cuda")
    pool = model.init_paged_pool(1 + slots, bs, dev)
    table = torch.arange(1, 1 + slots, dtype=torch.int32,
                         device=dev)[:, None].contiguous()
    ring = torch.full((slots,), bs, dtype=torch.int32, device=dev)
    tok = torch.ones(slots, dtype=torch.int32, device=dev)
    pos = torch.zeros(slots, dtype=torch.int32, device=dev)
    with torch.no_grad():
        events = device_events(torch, lambda: model.decode_step_paged(
            params, tok, pos, pool, table, ring), "decode step")
    del pool
    by_name: dict = {}
    for name, us in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    rec = dict(layers=cfg.num_layers, slots=slots, kernels=len(events),
               device_us=sum(us for _, us in events), by_name=by_name)
    for key, part in NORM_SITE_KERNELS.items():
        own = [v for k, v in by_name.items() if part in k]
        rec[f"{key}_launches"] = sum(n for n, _ in own)
        rec[f"{key}_us"] = sum(us for _, us in own)
    print(f"decode step of {cfg.name} at {cfg.num_layers} layers, {slots} "
          f"requests (one step traced): {rec['kernels']} device kernels, "
          f"{rec['device_us'] / 1e3:.4f} ms of device time; the norm "
          f"kernel {rec['norm_launches']} launches, "
          f"{rec['norm_us'] / 1e3:.4f} ms; PyTorch's adds (the residual "
          f"adds among them) {rec['add_launches']} launches, "
          f"{rec['add_us'] / 1e3:.4f} ms")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {n:5d}x {us / 1e3:8.4f} ms  {name[:110]}")
    return rec


def decode_step_fresh(label: str) -> dict:
    """``decode_step_record`` in a process of its own (the kernels built,
    minitron's params made anew there): a profiler session opened in
    this process after its many others (the launcher's --profile among
    them) missed the first 17 kernels of the traced step on the card,
    where a fresh process traced every one. Returns the record."""
    code = ("import json, sys; sys.path[:0] = ['src', '.']; import torch; "
            "import chip_smoke as cs; rec = []; "
            "cs.decode_step_record(torch, rec); "
            "print('DECODE-STEP ' + json.dumps(rec[0], default=str))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    out = proc.stdout.splitlines()
    print("\n".join(x for x in out if not x.startswith("DECODE-STEP ")))
    check(proc.returncode == 0, f"{label}: the decode step's trace failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(next(x for x in out if x.startswith(
        "DECODE-STEP "))[len("DECODE-STEP "):])


def decode_step_record(torch, record):
    """``decode_step_profile`` of minitron-8b CONFIG_SWA at its published
    widths and all 32 layers (params from seed 0, made on the card),
    appended to ``record`` (``decode_step_fresh``; scripts/phase3_ab.py's
    ``decode_step``)."""
    cfg = serve_config("minitron-8b")
    params, _ = serve_params(torch, cfg)
    record.append(decode_step_profile(torch, cfg, params))
    del params
    torch.cuda.empty_cache()


def row_invariance_probe(torch, idn, irn, cfg, B=4, c=64,
                         moe_cfg=None) -> dict:
    """Whether each row-wise reduction of a full-width serving step gives a
    row the same bits at M = B (a decode step) as at M = B c (a prefill
    chunk), on the card: the serving path's own ops (``invariant_dense``
    at minitron's wq, wk, wv, wo, the MLP and lm_head; both forms of
    ``invariant_rmsnorm`` at d_model; the logits' ``argmax``), each a
    check, and beside them the
    ops the path no longer calls (``torch.matmul`` at every projection,
    ``layers.rmsnorm``), reported as a yardstick. With ``moe_cfg`` also
    the MoE serving ops at its widths (``moe.moe_serve``): the router's
    f32 product on ``invariant_dense``, ``torch.softmax`` over its E
    columns, the stable sort of the top-k, the combine's per-row steps
    and one whole layer of ``moe_serve``, each a check, with
    ``torch.matmul`` of the router as a yardstick. Returns {op: max |difference|} (0.0
    where every row is bitwise equal)."""
    from repro_torch.models.layers import rmsnorm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d),
              "w_in": (d, cfg.d_ff), "w_gate": (d, cfg.d_ff),
              "w_out": (cfg.d_ff, d), "lm_head": (d, cfg.vocab_size)}

    def gap(fn, x):
        full = fn(x)
        rows = torch.cat([fn(x[:, i:i + 1].contiguous()) for i in range(c)],
                         1)
        return float((full.float() - rows.float()).abs().max())
    path, yard = {}, {}
    for name, (din, dout) in shapes.items():
        w = (torch.randn(din, dout, device=dev, generator=g)
             * din ** -0.5).to(torch.bfloat16)
        x = torch.randn(B, c, din, device=dev, generator=g).to(torch.bfloat16)
        path[f"invariant_dense {name}"] = gap(
            lambda t: idn.invariant_dense(t, w), x)
        yard[f"torch.matmul {name}"] = gap(lambda t: t @ w, x)
        if name == "lm_head":       # the same logits, B c rows or B
            lg = idn.invariant_dense(x, w)
            path["argmax"] = float(lg.argmax(-1).ne(torch.cat(
                [lg[:, i:i + 1].contiguous().argmax(-1) for i in range(c)],
                1)).sum())
            del lg
        del w, x
    x = torch.randn(B, c, d, device=dev, generator=g).to(torch.bfloat16)
    gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(
        torch.bfloat16)
    path["invariant_rmsnorm"] = gap(lambda t: irn.invariant_rmsnorm(t, gain),
                                    x)
    path["invariant_add_rmsnorm"] = gap(
        lambda t: torch.cat(irn.invariant_add_rmsnorm(t, t.flip(-1)
                                                      .contiguous(), gain),
                            -1), x)
    yard["layers.rmsnorm"] = gap(lambda t: rmsnorm({"g": gain}, t), x)
    del x
    if moe_cfg is not None:
        path.update(moe_row_invariance(torch, idn, moe_cfg, gap, yard, B, c))
    torch.cuda.empty_cache()
    bad = {k: v for k, v in path.items() if v}
    off = {k: v for k, v in yard.items() if v}
    print(f"row invariance (bf16, M = {B} against M = {B * c}): the serving "
          f"path's ops " + ("every one bitwise" if not bad else
                            f"NOT row-invariant: {bad}") +
          "; the ops it no longer calls: " +
          ("every one bitwise" if not off else
           f"NOT row-invariant: {off}"))
    check(not bad, f"row invariance: the serving path's {sorted(bad)} give a "
          f"row other bits at M = {B} than at M = {B * c}: {bad}")
    return {**path, **yard}


def moe_row_invariance(torch, idn, cfg, gap, yard, B, c) -> dict:
    """The MoE serving ops of ``row_invariance_probe`` at ``cfg``'s widths
    (one layer's parameters from a seed, on the card): returns the path's
    gaps and adds the yardsticks to ``yard``."""
    from repro_torch.models import moe
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(33)
    E, d = cfg.num_experts, cfg.d_model
    p = moe.moe_init(g, cfg, torch.bfloat16)
    rw = p["router"]["w"]
    xf = torch.randn(B, c, d, device=dev, generator=g)
    path = {"invariant_dense router (f32)": gap(
        lambda t: idn.invariant_dense(t, rw), xf)}
    yard["torch.matmul router (f32)"] = gap(lambda t: t @ rw, xf)
    lg = 4 * idn.invariant_dense(xf, rw)
    path["torch.softmax router"] = gap(lambda t: torch.softmax(t, -1), lg)
    probs = torch.softmax(lg, -1)
    path["moe top-k (stable sort)"] = gap(lambda t: torch.cat(
        [v.float() for v in moe._top_k(t, cfg.top_k)], -1), probs)
    ys = torch.randn(E, B, c, d, device=dev, generator=g).to(torch.bfloat16)

    def combine(rows):                  # the combine over rows ``rows``
        out = None
        for e in range(E):
            out = moe._combine_step(out, ys[e][:, rows].contiguous(),
                                    probs[:, rows, e:e + 1].contiguous())
        return out
    each = torch.cat([combine(slice(i, i + 1)) for i in range(c)], 1)
    path["moe combine (per-row steps)"] = float(
        (combine(slice(None)) - each).abs().max())
    xb = torch.randn(B, c, d, device=dev, generator=g).to(torch.bfloat16)
    path[f"moe_serve ({cfg.name}, one layer)"] = gap(
        lambda t: moe.moe_serve(p, cfg, t)[0], xb)
    del p, xf, lg, probs, ys, xb
    return path


def serve_contract(torch, serve_mod, ref):
    """The serving contracts at reduced size on the card. Always: the
    paged pool == the dense cache bitwise at the same chunk width (bf16,
    the window of 8 wrapping the ring: chunked prefill c 5 and per-token
    decode, logits and the cache through the block table); reduced f32
    on the card against the CPU (per-token decode and chunked prefill
    logits within rtol 1e-4, atol 1e-5: f32 products summed in other
    orders); chunked prefill == per-token decode bitwise (logits and
    cache) at (linear, c 4) and (window 8, c 5); and the three engines
    serve identical tokens (more requests than slots)."""
    import numpy as np

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.api import build_model
    from repro_torch.models.attention import paged_view
    from repro_torch.serve import LoopEngine, PagedEngine, Request
    from repro_torch.utils.tree import tree_map
    dev = torch.device("cuda")

    def build(window, dtype, device):
        cfg = reduced(ARCHS["minitron-8b"], dtype=dtype)
        if window:
            cfg = cfg.with_(sliding_window=window)
        model = build_model(cfg)
        return model, model.init(torch.Generator().manual_seed(0), device)

    def prompts(vocab, B, P, seed=0):
        rng = np.random.RandomState(seed)
        return rng.randint(1, vocab, (B, P)).astype(np.int32)

    def ids(a, device):
        return torch.tensor(a, dtype=torch.int32, device=device)

    def per_token(model, params, pr, max_len, device):
        B, P = pr.shape
        cache = model.init_decode_cache(params, B, max_len)
        out = [model.decode_step(params, ids(pr[:, t], device),
                                 ids(np.full(B, t), device), cache)[0]
               for t in range(P)]
        return torch.stack(out, 1), cache

    def chunked(model, params, pr, max_len, c, device, pool=None):
        B, P = pr.shape
        if pool is None:
            cache = model.init_decode_cache(params, B, max_len)
        else:
            nb, bs, table, lw = pool
            cache = model.init_paged_pool(nb, bs, device)
        lgs = []
        for t0 in range(0, P, c):
            n = min(c, P - t0)
            toks = np.zeros((B, c), np.int32)
            poss = np.full((B, c), ref.PAD_POS, np.int32)
            toks[:, :n] = pr[:, t0:t0 + n]
            poss[:, :n] = np.arange(t0, t0 + n)
            if pool is None:
                lg, cache = model.prefill(params, ids(toks, device),
                                          ids(poss, device), cache)
            else:
                lg, cache = model.prefill_paged(
                    params, ids(toks, device), ids(poss, device), cache,
                    table, lw)
            lgs.append(lg[:, :n])
        return torch.cat(lgs, 1), cache

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))

    with torch.no_grad():
        # paged == dense, bitwise, at the same chunk width
        model, params = build(8, "bfloat16", dev)
        B, P, max_len, bs, c = 2, 12, 24, 4, 5
        pr = prompts(model.cfg.vocab_size, B, P)
        L = min(max_len, 8)
        mb = L // bs
        nb = 1 + B * mb
        table = ids(np.arange(1, nb).reshape(B, mb), dev)
        lw = ids(np.full(B, L), dev)
        dense_lg, dense_c = chunked(model, params, pr, max_len, c, dev)
        paged_lg, pool = chunked(model, params, pr, max_len, c, dev,
                                 (nb, bs, table, lw))
        views = [x for g in ("body", "tail") for i in
                 range(pool[g]["k"].shape[0]) for x in paged_view(
                     {k: a[i] for k, a in pool[g].items()}, table)]
        dense_views = [x for g in ("body", "tail") for i in
                       range(dense_c[g]["k"].shape[0])
                       for x in (dense_c[g]["k"][i], dense_c[g]["v"][i],
                                 dense_c[g]["pos"][i])]
        check(torch.equal(dense_lg, paged_lg) and same(views, dense_views),
              "serving: paged chunked prefill differs from the dense cache's")
        tok_lg, _ = per_token(model, params, pr, max_len, dev)
        pool2 = model.init_paged_pool(nb, bs, dev)
        plg = torch.stack([model.decode_step_paged(
            params, ids(pr[:, t], dev), ids(np.full(B, t), dev), pool2,
            table, lw)[0] for t in range(P)], 1)
        check(torch.equal(tok_lg, plg),
              "serving: paged decode differs from the dense cache's")
        print("serving contract: paged == dense bitwise (bf16, window 8, "
              "chunked prefill c 5 and per-token decode, logits and cache)")

        # reduced f32, the card against the CPU
        worst = 0.0
        for window in (0, 8):
            model, p_cpu = build(window, "float32", torch.device("cpu"))
            p_dev = tree_map(lambda x: x.to(dev), p_cpu)
            pr = prompts(model.cfg.vocab_size, B, 11, seed=3)
            for fn in (lambda p, d: per_token(model, p, pr, 20, d),
                       lambda p, d: chunked(model, p, pr, 20, 4, d)):
                a, _ = fn(p_dev, dev)
                b, _ = fn(p_cpu, torch.device("cpu"))
                err = float((a.cpu() - b).abs().max())
                worst = max(worst, err)
                check(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5),
                      f"serving: reduced f32 (window {window}) logits on "
                      f"the card differ from the CPU's by {err:.3e}")
        print(f"serving contract: reduced f32 card == CPU within rtol "
              f"1e-4, atol 1e-5 (max |difference| {worst:.3e})")

        for window, c in ((0, 4), (8, 5)):
            model, params = build(window, "bfloat16", dev)
            pr = prompts(model.cfg.vocab_size, 2, 11)
            a, ca = per_token(model, params, pr, 20, dev)
            b, cb = chunked(model, params, pr, 20, c, dev)
            flat = lambda t: [x for g in ("body", "tail")
                              for x in t[g].values()]
            check(torch.equal(a, b) and same(flat(ca), flat(cb)),
                  f"serving: chunked prefill c {c} (window {window}) differs "
                  "from the per-token loop")
        model, params = build(0, "bfloat16", dev)

        def mk():
            rng = np.random.RandomState(1)
            return [Request(rid=i, max_new=6, prompt=rng.randint(
                1, model.cfg.vocab_size, (ln,)).tolist())
                for i, ln in enumerate([5, 11, 8, 14])]
        outs = [[r["tokens"] for r in eng.run(mk())] for eng in (
            LoopEngine(model, params),
            LoopEngine(model, params, prefill_chunk=4),
            PagedEngine(model, params, max_slots=2, block_size=4,
                        max_batch_tokens=64, prefill_chunk=4))]
        check(outs[0] == outs[1] == outs[2],
              "serving: the three engines served different tokens")
        print("serving contract: chunked == per token bitwise (logits and "
              "cache, (linear, c 4) and (window 8, c 5)); the three engines "
              "serve identical tokens")


def serving_families(torch, serve_mod, tf, kmods, ref, tree_mod,
                     main_record) -> dict:
    """Slice 17's configs served at their published widths, depth cut as
    SERVE_DEPTH says (bf16 params from seed 0, made on the card): one
    PagedEngine run each (SERVE_FAMILY_RUN, ``serve_run``: launches
    exact, no plain version, peak under 75 GB, tokens/s and the decode
    bound printed); the moe pair also through the loop engine per token,
    chunked 64 and paged (SERVE_FAMILY_LOOP_MIX), which must serve the
    per-token loop's tokens. Returns the kernels' launches summed over
    the runs."""
    from repro_torch.configs.registry import get_arch
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    for arch in SERVE_FAMILIES:
        cfg = serve_config(arch)
        params, init_s = serve_params(torch, cfg)
        n = sum(x.numel() for x in tree_mod.leaves(params))
        print(f"serving {arch}: {cfg.num_layers} of "
              f"{get_arch(arch).num_layers} "
              f"layers at its published widths (d {cfg.d_model}, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads}, d_ff "
              f"{cfg.d_ff}" + (f", {cfg.num_experts} experts top "
                               f"{cfg.top_k}" if cfg.num_experts else "")
              + (f", window {cfg.sliding_window}" if cfg.sliding_window
                 else "") + f"), {n:,} bf16 params "
              f"({sum(x.numel() * x.element_size() for x in tree_mod.leaves(params)) / 1e9:.1f}"
              f" GB) made on the card in {init_s:.1f} s")
        # only the counts are kept: an engine holds the params and pool
        add(serve_run(torch, serve_mod, tf, kmods, ref, cfg, params,
                      [*SERVE_FAMILY_RUN, "--device", "cuda"], "paged",
                      main_record, tree_mod)[2])
        if cfg.num_experts:
            tokens = {}
            for label, run in SERVE_LOOP_RUNS:
                res, engine, counts = serve_run(
                    torch, serve_mod, tf, kmods, ref, cfg, params,
                    [*run, *SERVE_FAMILY_LOOP_MIX, "--device", "cuda"],
                    label, main_record, tree_mod)
                del engine
                add(counts)
                tokens[label] = [r["tokens"] for r in res]
            agree = {k: v == tokens["loop per token"]
                     for k, v in tokens.items()}
            check(all(agree.values()), f"serving {arch}: loop chunked 64 / "
                  f"paged served other tokens than the per-token loop: "
                  f"{agree}")
            print(f"serving {arch} full width: loop chunked 64 and paged "
                  "serve the per-token loop's tokens")
        del params
        torch.cuda.empty_cache()
    return totals


def zamba2_serving(torch, serve_mod, tf, kmods, ref, tree_mod,
                   main_record) -> dict:
    """zamba2-1.2b served at its published widths and all 38 layers (bf16
    params from seed 0, made on the card) through the lockstep loop
    engine per token, twice (SERVE_ZAMBA_RUN, ``serve_run``: mamba2_fwd
    at S = 1 a layer a step, serve_attention and invariant_dense at the
    6 shared-attention sites, no other kernel and no plain version,
    tokens/s, the decode bound, peak under 75 GB): the two runs must
    serve the same tokens; the paged engine is refused by name. Returns
    the kernels' launches summed over the runs."""
    cfg = serve_config(ZAMBA)
    params, init_s = serve_params(torch, cfg)
    n = sum(x.numel() for x in tree_mod.leaves(params))
    print(f"serving {ZAMBA}: {cfg.num_layers} layers at its published "
          f"widths (d {cfg.d_model}, state {cfg.ssm_state}, shared "
          f"attention every {cfg.attn_every} blocks, {cfg.num_heads} heads "
          f"of {cfg.head_dim}), {n:,} params made on the card in "
          f"{init_s:.1f} s")
    totals, tokens = {}, []
    for run in (1, 2):
        res, engine, counts = serve_run(
            torch, serve_mod, tf, kmods, ref, cfg, params,
            [*SERVE_ZAMBA_RUN, "--device", "cuda"],
            f"loop per token, run {run}", main_record, tree_mod)
        del engine
        tokens.append([r["tokens"] for r in res])
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    check(tokens[0] == tokens[1], "serving zamba2: two runs served other "
          "tokens")
    print("serving zamba2 full width: two runs serve the same tokens")
    try:
        serve_mod.build_engine(serve_mod.build_model(cfg), params,
                               serve_mod.parser().parse_args(
                                   ["--engine", "paged"]))
    except ValueError as e:
        check("no paged serving path" in str(e), f"zamba2 paged: {e}")
        print(f"serving zamba2 paged: refused ({e})")
    else:
        fail("serving: the paged engine took the hybrid family")
    del params
    torch.cuda.empty_cache()
    return totals


#: slice 20's loop-engine runs: per token twice, then chunked 64 (over
#: SERVE_FAMILY_LOOP_MIX: a shared prefix of 23 tokens, one chunk with
#: 41 pad rows)
SERVE_SLICE20_LOOP = [("loop per token, run 1", ["--engine", "loop",
                                                 "--prefill-chunk", "0"]),
                      ("loop per token, run 2", ["--engine", "loop",
                                                 "--prefill-chunk", "0"]),
                      ("loop chunked 64", ["--engine", "loop",
                                           "--prefill-chunk", "64"])]


def slice20_serving(torch, serve_mod, tf, ed, kmods, ref, tree_mod,
                    main_record) -> dict:
    """phi-3-vision-4.2b at all 32 layers and whisper-medium at all 24 +
    24, at their published widths (bf16 params from seed 0, made on the
    card), served (``serve_run``: launches exact, no plain version, peak
    under 75 GB, tokens/s and the decode bound printed): the vlm by the
    paged engine twice (SERVE_FAMILY_RUN, the same tokens) and by the
    loop engine per token twice and chunked 64 (SERVE_FAMILY_LOOP_MIX);
    whisper by the loop engine per token twice and chunked 64 (its
    frames encoded once a run, its cross-attention on serve_attention's
    cross form, its lm_head padded to 51,872 columns), its paged engine
    refused by name. Every run of an arch serves the first run's tokens.
    Returns the kernels' launches summed over the runs."""
    from repro_torch.configs.registry import get_arch
    totals = {}
    for arch, steps, runs in (
            (VLM, tf, [(f"paged, run {i}", SERVE_FAMILY_RUN)
                       for i in (1, 2)]
             + [(label, [*run, *SERVE_FAMILY_LOOP_MIX])
                for label, run in SERVE_SLICE20_LOOP]),
            (WHISPER, ed, [(label, [*run, *SERVE_FAMILY_LOOP_MIX])
                           for label, run in SERVE_SLICE20_LOOP])):
        cfg = serve_config(arch)
        params, init_s = serve_params(torch, cfg)
        n = sum(x.numel() for x in tree_mod.leaves(params))
        print(f"serving {arch}: {cfg.num_layers} of "
              f"{get_arch(arch).num_layers} decoder layers at its published "
              f"widths (d {cfg.d_model}, {cfg.num_heads} heads of "
              f"{cfg.head_dim}, vocabulary {cfg.vocab_size}"
              + (f", {cfg.encoder_layers} encoder layers over "
                 f"{cfg.encoder_seq} frames" if cfg.encoder_layers else "")
              + f"), {n:,} bf16 params made on the card in {init_s:.1f} s")
        tokens = {}
        for label, argv in runs:
            res, engine, counts = serve_run(
                torch, serve_mod, steps, kmods, ref, cfg, params,
                [*argv, "--device", "cuda"], label, main_record, tree_mod)
            del engine
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            tokens[label] = [r["tokens"] for r in res]
        first = {}
        for label, tok in tokens.items():
            key = "paged" if label.startswith("paged") else "loop"
            first.setdefault(key, tok)
            check(tok == first[key], f"serving {arch}: {label} served other "
                  f"tokens than the first {key} run")
        print(f"serving {arch} full width: every run serves the first "
              f"run's tokens ({', '.join(tokens)})")
        if cfg.family == "audio":
            try:
                serve_mod.build_engine(serve_mod.build_model(cfg), params,
                                       serve_mod.parser().parse_args(
                                           ["--engine", "paged"]))
            except ValueError as e:
                check("no paged serving path" in str(e), f"{arch} paged: {e}")
                print(f"serving {arch} paged: refused ({e})")
            else:
                fail("serving: the paged engine took the audio family")
        del params
        torch.cuda.empty_cache()
    return totals


def serving(torch, serve_mod, tf, sa, rs, idn, irn, kmods, ref, tree_mod,
            main_record):
    """Phase 4's serving runs (module docstring): the row-invariance probe,
    the full-width runs (loop chunked 64 and paged serve the per-token
    loop's tokens: a check) and the reduced contracts. Returns the
    kernels' launches summed over the runs, and the probe's readings."""
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    cfg = serve_config("minitron-8b")
    probe = row_invariance_probe(torch, idn, irn, cfg,
                                 moe_cfg=serve_config(PHI))
    params, init_s = serve_params(torch, cfg)
    n = sum(x.numel() for x in tree_mod.leaves(params))
    print(f"serving minitron-8b CONFIG_SWA: {cfg.num_layers} layers, window "
          f"{cfg.sliding_window}, {n:,} bf16 params made on the card in "
          f"{init_s:.1f} s")
    argv = [*SERVE_PAGED_RUN, "--device", "cuda"]
    _, engine, counts = serve_run(torch, serve_mod, tf, kmods, ref, cfg,
                                  params, argv, "paged (4 slots, blocks of "
                                  "16, prefill chunk 64)", main_record,
                                  tree_mod)
    add(counts)
    sched, kv = engine.scheduler, engine.kv
    check(sched.admitted_order == sched.submitted_order
          and kv.free_blocks == kv.num_blocks - 1
          and max(len(v) for v in sched.slot_history.values()) >= 3,
          "serving paged: FIFO admission, slot reuse or block conservation "
          "broken")
    tokens = {}
    for label, run in SERVE_LOOP_RUNS:
        res, _, counts = serve_run(torch, serve_mod, tf, kmods, ref, cfg,
                                   params, [*run, *SERVE_LOOP_MIX,
                                            "--device", "cuda"],
                                   label, main_record, tree_mod)
        add(counts)
        tokens[label] = [r["tokens"] for r in res]
    serve_where_time_goes(torch, serve_mod, cfg, params)
    agree = {k: v == tokens["loop per token"] for k, v in tokens.items()}
    check(all(agree.values()), f"serving full width: loop chunked 64 / "
          f"paged served other tokens than the per-token loop: {agree}")
    print("serving full width: loop chunked 64 and paged serve the "
          "per-token loop's tokens")
    del params
    torch.cuda.empty_cache()
    step = decode_step_fresh("serving")
    whole = step["norm_launches"] == 2 * cfg.num_layers + 1
    print(f"decode step: the norm kernel launched {step['norm_launches']} "
          f"times in the trace ({2 * cfg.num_layers} with the add and 1 "
          f"alone expected: the trace {'whole' if whole else 'NOT whole'})")

    cfg = serve_config("rwkv6-3b")
    params, init_s = serve_params(torch, cfg)
    print(f"serving rwkv6-3b: {cfg.num_layers} layers, params made on the "
          f"card in {init_s:.1f} s")
    _, _, counts = serve_run(torch, serve_mod, tf, kmods, ref, cfg, params,
                             [*SERVE_RWKV_RUN, "--device", "cuda"],
                             "loop per token", main_record, tree_mod)
    add(counts)
    try:
        serve_mod.build_engine(serve_mod.build_model(cfg), params,
                               serve_mod.parser().parse_args(
                                   ["--engine", "paged"]))
    except ValueError as e:
        check("no paged serving path" in str(e), f"rwkv6 paged: {e}")
        print(f"serving rwkv6-3b paged: refused ({e})")
    else:
        fail("serving: the paged engine took the ssm family")
    del params
    torch.cuda.empty_cache()
    serve_contract(torch, serve_mod, ref)
    return totals, probe


# ----------------------------------------------------------------- build --

#: a mangled template argument: float, int8 (signed char), bf16, a
#: back-reference (only bf16 repeats among the kernels' arguments), an
#: integer or bool literal
# ------------------------------------------------ the sharded client axis --

#: slice 21: the paper CNN at its own cohort size (K 50, m 10: client
#: width 2 at W 2; quickstart's m 5 would give 1) for SHARD_ROUNDS rounds,
#: each algorithm under both client-axis routes
SHARD_ROUNDS = 5
SHARD_RUNS = [("ama_fes", []), ("async_ama", ["--max-delay", "3",
                                              "--p-delay", "0.3"]),
              ("fedavg", []), ("fedprox", []), ("fedopt", [])]
#: the port's tolerance for the pre-reduced axis against the fused plane
#: (tests/test_torch_legacy.py); fedopt's server Adam amplifies a
#: last-bit difference by up to lr / tau = 100
AUTO_TOL = dict(rtol=5e-4, atol=1e-5)
FEDOPT_RUN_TOL = dict(rtol=2e-2, atol=2e-2)


def shard_argv(algo, extra, mode):
    return ["--algorithm", algo, *extra, "--clients", "50",
            "--clients-per-round", "10", "--p-limited", "0.25",
            "--n-train", "1500", "--rounds", str(SHARD_ROUNDS),
            "--eval-every", str(SHARD_ROUNDS), "--client-reduce", mode]


class BlockedPlane:
    """While installed, the round's masked client plane runs each block
    of ``blocks`` contiguous cohorts in a call of its own and
    concatenates the rows: one process computing the rows as the ranks
    of a mesh of client width ``blocks`` do. cuBLAS's batched GEMMs and
    cuDNN's grouped convolutions give a cohort's rows other bits in a
    call of 5 cohorts than in one of 10, so this, not the plain one-call
    run, is what the sharded run must equal bitwise."""

    def __init__(self, torch, blocks):
        from repro_torch.core import round as rnd
        self.torch, self.rnd, self.blocks = torch, rnd, blocks

    def __enter__(self):
        torch, blocks = self.torch, self.blocks
        from repro_torch.utils.tree import tree_map
        self.real = real = self.rnd.make_local_train

        def make(model, fl, strategy=None):
            plane = real(model, fl, strategy)

            def local_train(g, batch, limited):
                n = limited.shape[0] // blocks
                outs = [plane(g, {k: v[i * n:(i + 1) * n]
                                  for k, v in batch.items()},
                              limited[i * n:(i + 1) * n])
                        for i in range(blocks)]
                return (tree_map(lambda *xs: torch.cat(xs),
                                 *[o[0] for o in outs]),
                        torch.cat([o[1] for o in outs]))
            return local_train
        self.rnd.make_local_train = make
        return self

    def __exit__(self, *exc):
        self.rnd.make_local_train = self.real


def shard_child(rank, world, store, out, backend, cases):
    """One rank of phase 8 (spawned): joins the group over ``store``, runs
    ``cases`` [(label, argv)] through the launcher, each with the kernels'
    counts set to 0 just before and read just after, and writes its
    losses, accuracy, launches and collective span and bytes
    (``{out}/{label}_r{rank}.json``) and, for the CNN, its state
    (``.npz``); a pod run checks instead that every rank holds bitwise
    the same params (a gather of each leaf). Ranks that share a card see
    only it (the first visible one), so the backend rule picks gloo."""
    if backend == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.io import save
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import server_plane as sp
    from repro_torch.launch import train
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import leaves
    dev = resolve_device("cuda")
    build.load()
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, **kw)
    try:
        for label, argv in cases:
            for m in (sp, fa):
                m.reset_counts()
            with KeepRunner(train) as kr:
                res = train.main(argv)
            counts = {k: fn.launches for m in (sp, fa)
                      for k, fn in m.KERNELS.items()}
            rec = {"launches": counts, "device": str(dev)}
            if "--pod" in argv:
                state, metrics, _ = res
                runner = kr.runners[-1]
                rec.update(loss=[float(x) for x in metrics["loss"]],
                           acc=[], replicas_equal=all(
                               bool(torch.equal(g[0], g[1]))
                               for g in (_gather_rows(dist, world, x)
                                         for x in leaves(state["params"]))))
            else:
                sim, hist = res
                state, runner = sim.state, sim.runner
                rec.update(loss=hist.train_loss, acc=hist.test_acc)
                save(f"{out}/{label}_r{rank}.npz", state)
            rec.update(collective=runner.timer.summary().get("collective",
                                                             {}),
                       bytes=runner.collective.bytes_in)
            with open(f"{out}/{label}_r{rank}.json", "w") as f:
                json.dump(rec, f)
            print(f"rank {rank} on {dev} ({backend}) {label}: launches "
                  f"{ {k: v for k, v in counts.items() if v} }, collective "
                  f"{rec['collective']}, {rec['bytes']:,} bytes in",
                  flush=True)
    finally:
        dist.destroy_process_group()


def _gather_rows(dist, world, x):
    parts = [x.new_empty(x.shape) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return parts


def _trees_equal(torch, tree_mod, a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_mod.flatten(a), tree_mod.flatten(b), strict=True))


def _states_close(torch, tree_mod, a, b, tol) -> float:
    """Largest |a - b| over every leaf; fails beyond ``tol``."""
    worst = 0.0
    for (k, x), (_, y) in zip(tree_mod.flatten(a), tree_mod.flatten(b),
                              strict=True):
        x, y = x.float(), y.float()
        worst = max(worst, float((x - y).abs().max()))
        check(bool(torch.allclose(x, y, **tol)),
              f"{k}: differs beyond {tol} (max |diff| {worst:.3e})")
    return worst


def sharded_nccl_w1(torch, train, tree_mod, kept, tmp, main_record):
    """(a) W = 1 over NCCL in this process: minitron-8b at full width (2
    layers), C 2, POD_ROUNDS rounds of ama_fes with the rows gathered
    (``--client-reduce off``) over a one-rank group on a ``file://``
    store: losses and final params bitwise the meshless ama_fes run of
    ``pod_main_path`` (``kept``). Returns its launches."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import server_plane as sp
    params_on, loss_on, _ = kept
    argv = [*pod_argv("minitron-8b"), "--algorithm", "ama_fes", "--rounds",
            str(POD_ROUNDS), "--client-reduce", "off"]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_WORLD_SIZE="1")
    os.environ.update(env)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store_a",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        torch.cuda.reset_peak_memory_stats()
        for m in (sp, fa):
            m.reset_counts()
        with KeepRunner(train) as kr:
            state, metrics, dt = run_pod(torch, train, argv,
                                         llm_full_width("minitron-8b"))
        counts = {k: fn.launches for m in (sp, fa)
                  for k, fn in m.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    runner = kr.runners[-1]
    span = runner.timer.summary().get("collective", {})
    params = tree_mod.leaves(state["params"])
    same = all(torch.equal(x.cpu(), y)
               for x, y in zip(params, params_on, strict=True))
    loss = [float(x) for x in metrics["loss"]]
    nbytes = sum(x.numel() * x.element_size() for x in params)
    del state, params
    torch.cuda.empty_cache()
    print(f"sharded (a) minitron-8b W 1 over NCCL, C {POD_C}, {POD_ROUNDS} "
          f"rounds, rows gathered: params and losses bitwise the meshless "
          f"run: {same and loss == list(loss_on)}; collective span {span} "
          f"(a gather of {POD_C} x {nbytes:,} bytes and of the losses a "
          f"round; {runner.collective.bytes_in:,} bytes from other ranks); "
          f"{dt:.3f} s; peak {peak / 1e9:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    check(same, "sharded (a): params differ from the meshless run")
    check(loss == [float(x) for x in loss_on],
          f"sharded (a): losses {loss} against {list(loss_on)}")
    check(span.get("calls", 0) == 2 * POD_ROUNDS,
          f"sharded (a): {span} collective spans, expected a gather of the "
          "rows and one of the losses a round")
    main_record.append(dict(run="sharded (a) minitron-8b W 1 nccl",
                            seconds=dt, collective=span, peak_bytes=peak,
                            row_bytes=nbytes))
    return counts


def sharded_runs(torch, train, tree_mod, tmp, kept_loss, main_record):
    """(b) W = 2 ranks sharing the card over gloo (one spawn of two
    processes running every case): the paper CNN at K 50, m 10 (5 cohorts
    a rank), SHARD_ROUNDS rounds of each of SHARD_RUNS under "off" (the
    rows gathered before the server kernel) and "auto" (the pre-reduced
    axis, a rank-ordered sum), against this process's one-rank runs:
    "off" bitwise the blocked one-process run (``BlockedPlane``) and
    within AUTO_TOL of the plain one, "auto" within AUTO_TOL of the plain
    one (fedopt at FEDOPT_RUN_TOL), both ranks bitwise the same state.
    (c) W = 2 over NCCL, one card a rank, where there are two cards:
    minitron-8b as in (a), one cohort a card, the ranks bitwise the same
    params and falling losses (one cohort a call is not bitwise two a
    call on the card; ``kept_loss``, the meshless losses, is printed
    beside). Returns the children's launches."""
    import torch.multiprocessing as mp
    from repro_torch.checkpoint.io import restore_state
    out = os.path.join(tmp, "shard")
    os.makedirs(out, exist_ok=True)
    cases = [(f"{algo}-{mode}", shard_argv(algo, extra, mode))
             for algo, extra in SHARD_RUNS for mode in ("off", "auto")]
    t0 = time.perf_counter()
    mp.start_processes(shard_child, args=(2, os.path.join(out, "store"),
                                          out, "gloo", cases),
                       nprocs=2, start_method="spawn")
    wall = time.perf_counter() - t0
    launches: dict = {}
    for algo, extra in SHARD_RUNS:
        one, one_hist, _ = run_train(torch, train,
                                     shard_argv(algo, extra, "off"))
        with BlockedPlane(torch, 2):
            blocked, blocked_hist, _ = run_train(
                torch, train, shard_argv(algo, extra, "off"))
        tol = FEDOPT_RUN_TOL if algo == "fedopt" else AUTO_TOL
        for mode in ("off", "auto"):
            states, info = [], []
            for rank in (0, 1):
                tag = os.path.join(out, f"{algo}-{mode}_r{rank}")
                states.append(restore_state(tag + ".npz", one.state))
                with open(tag + ".json") as f:
                    info.append(json.load(f))
                for k, v in info[-1]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            check(_trees_equal(torch, tree_mod, states[0], states[1]),
                  f"sharded (b) {algo} {mode}: the ranks' states differ")
            check(all(i["device"] == "cuda:0" for i in info),
                  f"sharded (b): ranks on {[i['device'] for i in info]}")
            worst = _states_close(torch, tree_mod, states[0], one.state,
                                  tol)
            exact = _trees_equal(torch, tree_mod, states[0], one.state)
            line = (f"sharded (b) CNN {algo} {mode}, W 2 over gloo on one "
                    f"card, K 50, m 10, {SHARD_ROUNDS} rounds: max |diff| "
                    f"{worst:.3e} against one process (bitwise {exact}), ")
            if mode == "off":
                same = _trees_equal(torch, tree_mod, states[0],
                                     blocked.state)
                check(same, f"sharded (b) {algo} off: not bitwise the "
                      "blocked one-process run")
                check(info[0]["loss"] == blocked_hist.train_loss,
                      f"sharded (b) {algo} off: losses differ from the "
                      "blocked one-process run")
                line += "bitwise the blocked one-process run, "
            acc = info[0]["acc"][-1]
            line += (f"accuracy {acc:.4f} (one process "
                     f"{one_hist.test_acc[-1]:.4f}); collective "
                     f"{info[0]['collective']}, {info[0]['bytes']:,} bytes "
                     "into rank 0")
            print(line)
            main_record.append(dict(run=f"sharded (b) {algo} {mode}",
                                    collective=info[0]["collective"],
                                    bytes_in=info[0]["bytes"],
                                    max_diff=worst, bitwise=exact))
    print(f"sharded (b): the two ranks' spawn took {wall:.1f} s")
    n = torch.cuda.device_count()
    if n < 2:
        print(f"sharded (c) W 2 over NCCL, one card a rank: not run, the "
              f"machine has {n} card")
        return launches
    argv = [*pod_argv("minitron-8b"), "--algorithm", "ama_fes", "--rounds",
            str(POD_ROUNDS), "--client-reduce", "off"]
    mp.start_processes(shard_child, args=(2, os.path.join(out, "store_c"),
                                          out, "nccl", [("pod", argv)]),
                       nprocs=2, start_method="spawn")
    info = []
    for rank in (0, 1):
        with open(os.path.join(out, f"pod_r{rank}.json")) as f:
            info.append(json.load(f))
        for k, v in info[-1]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    loss = info[0]["loss"]
    print(f"sharded (c) minitron-8b W 2 over NCCL on {info[0]['device']} "
          f"and {info[1]['device']}, one cohort a card: losses {loss} "
          f"(meshless {[float(x) for x in kept_loss]}); collective "
          f"{info[0]['collective']}, {info[0]['bytes']:,} bytes into rank 0")
    check(all(i["replicas_equal"] for i in info),
          "sharded (c): the ranks' params differ")
    check(info[0]["loss"] == info[1]["loss"] and all(
        math.isfinite(x) for x in loss) and loss[-1] < loss[0],
          f"sharded (c): losses {info[0]['loss']} / {info[1]['loss']}")
    return launches


_TARG = r"f|a|13__nv_bfloat16|S\d*_|L[ib]\d+E"


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel symbol (the length-prefixed
    identifier that ends in ``_kernel``, then its float / int8 / bf16 /
    integer template arguments); the symbol itself when there is none."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for i in range(len(digits)):
            n, at = int(digits[i:]), m.end()
            ident = mangled[at:at + n]
            if n and ident.endswith("_kernel") and ident.isidentifier():
                rest = re.match(rf"I((?:{_TARG})+)E", mangled[at + n:])
                names = {"f": "float", "a": "int8"}
                toks = [names.get(a, a[2:-1] if a.startswith("L") else
                                  "bf16")
                        for a in re.findall(_TARG, rest.group(1))] \
                    if rest else []
                return ident + (f"<{', '.join(toks)}>" if toks else "")
    return mangled


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas=-v log: its name
    and template arguments, registers, spills and static shared memory
    (the tensor-core flash kernels' tiles are dynamic shared memory,
    sized in their source); then every note that ptxas serialized
    wgmma."""
    lines, name, spill = [], "?", ""
    for raw in log.splitlines():
        line = raw.strip()
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info") and ": Used" in line:
            lines.append(f"{name}: {line.split(': Used', 1)[1].strip()}; "
                         f"{spill}")
        elif "C7512" in line or "serialized" in line:
            lines.append("WARNING " + line)
    return lines


# ------------------------------------------------------------------ main --

def main() -> None:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    # CUPTI torn down after a profiler session and set up again for the
    # next one with CUDA graphs captured in between (``device_ms``) is
    # what PyTorch itself switches off: a session then traced no device
    # activity at all, three times in a row, in one run of this script
    os.environ["TEARDOWN_CUPTI"] = "0"
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(card, flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{path.relative_to(ROOT)}")
    clock = PhaseClock(t_start)
    for line in ptxas_summary(log):
        print("  " + line)
    clock.mark("1-2, the header and the build")

    from repro_torch.kernels import ama_mix as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import invariant_dense as idn
    from repro_torch.kernels import invariant_rmsnorm as irn
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import serve_attention as sa
    from repro_torch.kernels import server_plane as sp
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree as tree_mod
    from repro_torch.utils.device import resolve_device
    resolve_device("cuda")

    recs = {k: [] for k in {**sp.KERNELS, **fa.KERNELS, **rs.KERNELS,
                            **sa.KERNELS, **idn.KERNELS, **irn.KERNELS,
                            **ms.KERNELS}}
    flash_rec, rwkv_rec, serve_rec, mamba_rec, cross_rec = [], [], [], [], []
    main_rec = []
    kmods = (sp, fa, rs, ms)
    zk = KernelSet(ms, fa)        # zamba2's two kernel families
    check_server_mix(torch, sp, ref, recs["server_mix"])
    check_server_mix_llm(torch, sp, ref, recs["server_mix"], LLM_N, "LLM")
    check_server_mix_llm(torch, sp, ref, recs["server_mix"], RWKV_N,
                         "rwkv6 LLM")
    check_server_async(torch, sp, ref, recs["server_async"])
    check_server_adam(torch, sp, ref, recs["server_adam"])
    check_server_mix_delta(torch, sp, ref, recs["server_mix_delta"])
    check_server_mix_scatter(torch, sp, ref, recs["server_mix_scatter"])
    check_ama_mix(torch, am, ref, recs["ama_mix"])
    check_flash(torch, fa, ref, flash_rec)
    check_rwkv6(torch, rs, ref, rwkv_rec)
    clock.mark("3, the server, ama_mix, flash and rwkv6 kernels against "
               "their plain versions")
    check_mamba2(torch, ms, ref, mamba_rec)
    clock.mark("3, the mamba2 kernels against their plain versions")
    check_serve_attention(torch, sa, ref, serve_rec)
    check_serve_cross(torch, sa, ref, cross_rec)
    check_invariant_dense(torch, idn, ref, recs["invariant_dense"])
    check_invariant_rmsnorm(torch, irn, ref, recs["invariant_rmsnorm"],
                            recs["invariant_add_rmsnorm"])
    clock.mark("3, the serving kernels against their plain versions")
    # one short run first, so one-time CUDA/cuDNN set-up is not booked
    # against the first main-path run
    run_train(torch, train, ["--algorithm", "ama_fes", *QUICKSTART,
                             "--rounds", "2"])
    launches = main_path(torch, train, sp, ref, tree_mod, MAIN_RUNS,
                         main_rec)
    legacy = main_path(torch, train, sp, ref, tree_mod, LEGACY_RUNS,
                       main_rec)
    part = main_path(torch, train, sp, ref, tree_mod, PARTITIONED_RUNS,
                     main_rec)
    planes_side_by_side(main_rec)
    static = fes_static_cnn(torch, train, sp, tree_mod, main_rec)
    clock.mark("4, the CNN's main paths and client planes")
    scen = scenario_runs(torch, train, sp, ref, tree_mod, main_rec)
    fed = federation_scale(torch, sp, tree_mod, main_rec)
    clock.mark("4, scenarios and the federation scale")
    # one draw a full-width config for the pod runs of phases 4-7
    with MemoInit(tf, [llm_full_width(a) for a in MEMO_ARCHS]) as memo, \
            MemoInit(ed, [llm_full_width(WHISPER)]):
        llm, kept = pod_main_path(torch, train, "minitron-8b", fa, kmods,
                                  ref, tree_mod, main_rec)
        clock.mark("4, the minitron-8b pod path")
        # slice 21: the sharded client axis, (a) beside the meshless run
        # it must equal, then (b) and (c)
        torch.cuda.empty_cache()
        print(f"sharded: this process holds "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
        with tempfile.TemporaryDirectory() as tmp:
            shard_a = sharded_nccl_w1(torch, train, tree_mod, kept, tmp,
                                      main_rec)
            shard_b = sharded_runs(torch, train, tree_mod, tmp, kept[1],
                                   main_rec)
        del kept
        clock.mark("8, the sharded client axis")
        llm_planes = pod_client_planes(torch, train, "minitron-8b", fa,
                                       kmods, ref, tree_mod, main_rec)
        rwkv, (_, _, peak_at_8) = pod_main_path(torch, train, "rwkv6-3b",
                                                rs, kmods, ref, tree_mod,
                                                main_rec)
        rwkv_planes = pod_client_planes(torch, train, "rwkv6-3b", rs, kmods,
                                        ref, tree_mod, main_rec)
        deep = rwkv6_deep(torch, train, rs, kmods, tree_mod, peak_at_8,
                          main_rec)
        clock.mark("4, the LLM pod paths")
        moe_pod = moe_pod_path(torch, train, fa, kmods, ref, tree_mod,
                               main_rec)
        clock.mark("4, the phi3.5-moe pod path")
        zamba = zamba2_pod_path(torch, train, zk, kmods, ref, tree_mod,
                                main_rec)
        clock.mark("4, the zamba2 pod path")
        s20_pod = slice20_pod_paths(torch, train, fa, kmods, ref, tree_mod,
                                    main_rec)
        memo.drop(llm_full_width(VLM))        # its last full-width run
        clock.mark("4, the phi-3-vision and whisper pod paths")
        served, _ = serving(torch, serve_mod, tf, sa, rs, idn, irn,
                            (*kmods, sa, idn, irn), ref, tree_mod, main_rec)
        clock.mark("4, serving")
        families = serving_families(torch, serve_mod, tf,
                                    (*kmods, sa, idn, irn), ref, tree_mod,
                                    main_rec)
        clock.mark("4, serving the moe and large dense configs")
        zserved = zamba2_serving(torch, serve_mod, tf,
                                 (*kmods, sa, idn, irn), ref, tree_mod,
                                 main_rec)
        clock.mark("4, serving zamba2")
        s20_served = slice20_serving(torch, serve_mod, tf, ed,
                                     (*kmods, sa, idn, irn), ref, tree_mod,
                                     main_rec)
        clock.mark("4, serving phi-3-vision and whisper")
        launches = {k: sum(run.get(k, 0) for run in (
            launches, legacy, part, static, scen, fed, llm, llm_planes, rwkv,
            rwkv_planes, deep, moe_pod, served, families, zamba, zserved,
            s20_pod, s20_served, shard_a, shard_b))
            for k in recs}
        fused_vs_plain(torch, train, tree_mod)
        legacy_kernel_vs_plain(torch, train, tree_mod)
        client_planes_per_cohort(torch, tree_mod)
        for arch, km in (("minitron-8b", fa), ("rwkv6-3b", rs)):
            for plane in ("masked", "partitioned"):
                llm_card_vs_cpu(torch, train, arch, km, tree_mod, plane)
        clock.mark("5, card against plain and CPU")
        port_contract(torch, train, tree_mod)
        llm_contract(torch, train, "minitron-8b", tree_mod)
        llm_contract(torch, train, "rwkv6-3b", tree_mod)
        llm_partitioned_contract(torch, train, "minitron-8b", tree_mod)
        moe_reduced_on_card(torch, train, fa, tree_mod)
        zamba2_reduced_on_card(torch, train, zk, tree_mod)
        slice20_reduced_on_card(torch, train, fa, tree_mod)
        with tempfile.TemporaryDirectory() as tmp:
            restart_contract(torch, train, tree_mod, tmp)
            prefetch_and_metrics(torch, train, tree_mod, tmp)
            clock.mark("5-6, the port's contracts and the reduced moe, "
                       "mixtral, qwen, zamba2, phi-3-vision and whisper "
                       "paths")
            where_time_goes(torch, train)
            llm_where_time_goes(torch, train, "minitron-8b", tmp)
            llm_where_time_goes(torch, train, "minitron-8b", tmp,
                                (*PARTITIONED, "--p-limited", "1.0"))
            memo.drop(llm_full_width("minitron-8b"))     # its last pod run
            llm_where_time_goes(torch, train, "rwkv6-3b", tmp)
            memo.drop(llm_full_width("rwkv6-3b"))
            moe_where_time_goes(torch, train, fa, tmp)
            zamba2_where_time_goes(torch, train, tmp)
            whisper_where_time_goes(torch, train, tmp)
    clock.mark("7, profiles")

    f32 = "torch.float32"
    main_shape = {  # the row of each kernel at the main path's shape
        "server_mix": dict(K=MAIN_K, N=MAIN_N, dtype=f32, case="t=7"),
        "server_async": dict(K=MAIN_K, Q=MAIN_Q, N=MAIN_N, dtype=f32,
                             case="t"),
        "server_adam": dict(K=MAIN_K, N=MAIN_N, dtype=f32, case="step 37"),
        "server_mix_delta": dict(K=MAIN_K, N=MAIN_N, dtype=f32,
                                 rows="torch.int8", case="t=7"),
        "server_mix_scatter": dict(K=MAIN_K, N=MAIN_N, dtype=f32,
                                   case="t=7")}
    replaces = {"server_mix": "kernels/server_plane.py:166",
                "server_async": "kernels/server_plane.py:257",
                "server_adam": "kernels/server_plane.py:303",
                "server_mix_delta": "kernels/server_plane.py:193",
                "server_mix_scatter": "kernels/server_plane.py:226",
                "ama_mix": "kernels/ama_mix.py:33",
                "flash_fwd": "kernels/flash_attention.py:76",
                # the TPU path has no backward kernel: XLA differentiates
                # chunked_attention
                "flash_bwd_dq": "models/attention.py:44",
                "flash_bwd_dkdv": "models/attention.py:44",
                "rwkv6_fwd": "kernels/rwkv6_scan.py:49",
                # no TPU kernel: XLA einsums of the serving attention
                # (also :238, :354, :389)
                "serve_attention": "models/attention.py:166",
                # no TPU kernel: the XLA einsums of cross_attention_decode
                "serve_cross_attention": "models/attention.py:200",
                # no TPU kernel: the XLA dot and reduction of the serving
                # projections and norms
                "invariant_dense": "models/layers.py:22",
                "invariant_rmsnorm": "models/layers.py:41",
                "invariant_add_rmsnorm": "models/layers.py:41",
                # the TPU path has no backward kernel: XLA differentiates
                # the scan of time_mix
                "rwkv6_bwd": "models/rwkv6.py:119",
                # no TPU kernel: the lax.scan of the SSD recurrence and
                # its XLA autodiff
                "mamba2_fwd": "models/mamba2.py:113",
                "mamba2_bwd": "models/mamba2.py:113"}
    source = {"server_mix": "server_plane.cu", "server_async":
              "server_plane.cu", "server_adam": "server_adam.cu",
              "server_mix_delta": "server_mix_compressed.cu",
              "server_mix_scatter": "server_mix_compressed.cu",
              "ama_mix": "ama_mix.cu",
              # the main path's bf16 calls run the tensor-core kernels
              "flash_fwd": "flash_attention_sm90.cu",
              "flash_bwd_dq": "flash_attention_sm90.cu",
              "flash_bwd_dkdv": "flash_attention_sm90.cu",
              "rwkv6_fwd": "rwkv6_scan.cu", "rwkv6_bwd": "rwkv6_scan.cu",
              "serve_attention": "serve_attention.cu",
              "serve_cross_attention": "serve_attention.cu",
              "invariant_dense": "invariant_dense.cu",
              "invariant_rmsnorm": "invariant_rmsnorm.cu",
              "invariant_add_rmsnorm": "invariant_rmsnorm.cu",
              "mamba2_fwd": "mamba2_scan.cu", "mamba2_bwd": "mamba2_scan.cu"}
    # the flash rows at minitron's shape as the main path calls it (GQA)
    flash_main = next(r for r in flash_rec if r["case"] == FLASH_GQA)
    flash_err = {"flash_fwd": "err_fwd", "flash_bwd_dq": "err_dq",
                 "flash_bwd_dkdv": "err_dkdv"}
    rwkv_main = next(r for r in rwkv_rec if r["case"] == RWKV_MAIN)
    rwkv_err = {"rwkv6_fwd": "err_fwd", "rwkv6_bwd": "err_bwd"}
    mamba_main = next(r for r in mamba_rec if r["case"] == MAMBA_MAIN)
    mamba_err = {"mamba2_fwd": "err_fwd", "mamba2_bwd": "err_bwd"}
    kernels = []
    for name in recs:
        check(launches[name] > 0, f"{name}: never launched on the main path")
        if name in fa.KERNELS:
            row = flash_main[name]
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r[flash_err[name]] for r in flash_rec)
        elif name in rs.KERNELS:
            row = rwkv_main[name]
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r[rwkv_err[name]] for r in rwkv_rec)
        elif name in ms.KERNELS:   # zamba2's pod shape
            row = mamba_main[name]
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r[mamba_err[name]] for r in mamba_rec)
        elif name == "serve_cross_attention":   # whisper's decode
            row = next(r for r in cross_rec if r["case"] == CROSS_MAIN)
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r["err"] for r in cross_rec)
        elif name in sa.KERNELS:   # minitron's decode over its ring
            row = next(r for r in serve_rec if r["case"] == SERVE_MAIN)
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r["err"] for r in serve_rec)
        elif name in idn.KERNELS or name in irn.KERNELS:
            # minitron's decode step (M 4): w_out, the norm at d 4096
            main_case = ("w_out", 4) if name in idn.KERNELS else RMS_MAIN
            row = next(r for r in recs[name] if r["case"] == main_case)
            b, by = row["bound_ms"], row["bound_by"]
            err = max(r["err"] for r in recs[name] if "err" in r)
        else:
            rec = recs[name]
            # ama_mix: one legacy round of the CNN, one call
            row = (ama_mix_round_row(rec) if name == "ama_mix" else next(
                r for r in rec
                if all(r.get(k) == v for k, v in main_shape[name].items())))
            b, by = bound_ms(row["nbytes"], row["flops"])
            err = max(r["err"] for r in rec)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source[name]}",
            "replaces": f"src/repro/{replaces[name]}",
            "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": row["library_ms"]})
    for r in main_rec:
        print("main:", json.dumps(r))
    for name, rec in recs.items():
        if name in sp.KERNELS:
            by = {d: sum(r.get("design") == d for r in rec)
                  for d in sp.MIX_DESIGNS}
            print(f"{name}: bitwise equal to the plain version in "
                  f"{sum(r['exact'] for r in rec)} of {len(rec)} cases"
                  + (f", by kernel {by}" if any(by.values()) else ""))
    print(trace_summary())
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s on the card, "
          "build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
