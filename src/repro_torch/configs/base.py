"""Config dataclasses for models and federated runs.

The port's own copy of the JAX package's ``configs/base.py``: the same
fields with the same defaults, so a config written for one package
describes the same run in the other. ``core.round`` refuses a
``client_reduce`` or ``client_plane`` value it has no path for. The
comm plane (``comm_*``), fedprox and fedopt (``fedprox_*``,
``server_*``), every environment (the bandwidth ``bw_*``, the
Gilbert–Elliott ``ge_*`` and the trace's ``trace_path`` knobs), the
``population`` realisation (dense or virtual), pod scale (``cohorts``,
``local_steps``), ``client_reduce``, telemetry (``extended_metrics``)
and the masked, partitioned and ``fes_static`` client planes are
honoured. ``reduced`` is the JAX package's CPU-sized same-family
variant of a model config.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per ``configs/<arch>.py``."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0          # 0 for attention-free families
    num_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 0     # >0: blocked dispatch over token groups —
                                # one-hot dispatch FLOPs become linear in T
                                # instead of quadratic (see EXPERIMENTS §Perf)
    # --- attention details ---
    sliding_window: int = 0     # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mlp_gated: bool = True      # SwiGLU vs plain GELU MLP
    # --- SSM / linear attention ---
    ssm_state: int = 0          # mamba2 state size
    conv_width: int = 4
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0         # insert a (shared) attention block every N blocks
    shared_attn: bool = False   # one shared attention param set (Zamba2)
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0        # precomputed frame embeddings length
    # --- VLM ---
    num_patches: int = 0        # precomputed patch embeddings length
    vision_dim: int = 0         # stub frontend output dim (projected to d_model)
    # --- numerics / sharding ---
    dtype: str = "bfloat16"
    train_fsdp: bool = False    # shard params over the dsub axis during training
    serve_2d: bool = False      # 2-D tensor parallel at serving time (very large)
    remat: bool = True
    unroll_chunks: bool = False # unroll attention KV-chunk loop (dry-run: makes
                                # cost_analysis see every chunk; scans are
                                # otherwise costed once by HloCostAnalysis)
    unroll_layers: bool = False # unroll the layer scan (roofline calibration
                                # lowerings at reduced depth)
    shard_residuals: bool = False  # store the per-layer activation
                                # checkpoints model-sharded (d on "model"):
                                # 16x smaller residual stack for one extra
                                # all-gather per layer in backward (§Perf H3)
    attn_chunk: int = 512       # KV chunk for online-softmax attention
    # --- FES split (paper Eq. 2): classifier = final norm + head + tail blocks
    fes_tail_layers: int = 2
    # --- provenance ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

@dataclass(frozen=True)
class FLConfig:
    """Federated-learning runtime config (paper Table I defaults)."""

    num_clients: int = 50          # K
    clients_per_round: int = 10    # m
    rounds: int = 200              # B
    local_epochs: int = 10         # e
    local_batch_size: int = 32
    lr: float = 0.001              # epsilon
    # AMA (paper: alpha0=0.1, eta=2.5e-3, b=0.6)
    alpha0: float = 0.1
    eta: float = 2.5e-3
    staleness_b: float = 0.6
    alpha_cap: float = 0.95        # keep beta > 0 for long runs
    # heterogeneity simulation
    p_limited: float = 0.25        # ratio of computing-limited devices
    p_delay: float = 0.0           # prob. of transmission delay (0.3 / 0.7)
    max_delay: int = 0             # 5 / 10 / 15 rounds; 0 disables async path
    # environment name (see repro.env registry):
    # "bernoulli" | "gilbert_elliott" | "bandwidth" | "trace"
    env: str = "bernoulli"
    # gilbert_elliott: two-state Markov fading channel
    ge_p_gb: float = 0.15          # Good -> Bad transition prob per round
    ge_p_bg: float = 0.45          # Bad -> Good
    ge_p_delay_good: float = 0.05  # delay prob on a Good link
    ge_p_delay_bad: float = 0.9    # delay prob on a Bad link
    # bandwidth: log-normal uplink rate vs a round deadline
    bw_upload_mbits: float = 4.0   # model-update upload size (megabits)
    bw_mean_mbps: float = 2.0      # median uplink rate
    bw_sigma: float = 0.8          # log-std (shadow fading)
    bw_deadline_s: float = 1.0     # round deadline (seconds)
    # trace: .npz replay path ("" -> synthetic mobility trace)
    trace_path: str = ""
    # population realisation (repro.env.virtual): "auto" keeps the dense
    # bit-identical paper path up to VIRTUAL_K_MIN clients and switches
    # to the K-free hashed VirtualPopulation machinery above it;
    # "dense"/"virtual" force either at any K
    population: str = "auto"
    # staging look-ahead: how many chunks ChunkPrefetcher keeps in
    # flight ahead of the device (host memory ~ depth x chunk bytes)
    prefetch_depth: int = 1
    # pre-reduce the stacked (C, N) client plane to the (N,) weighted
    # sums the server planes actually consume BEFORE the server update,
    # so the cross-device collective moves N, not C x N, bytes:
    #   "auto"  — on when the active mesh's client axis is > 1
    #   "off"   — always the stacked fused path
    #   "force" — always reduce (CPU equivalence tests)
    client_reduce: str = "auto"
    # server strategy name (see repro.core.strategies registry):
    # "ama" (alias "ama_fes") | "async_ama" | "fedavg" | "fedprox" | "fedopt"
    algorithm: str = "ama_fes"
    fedprox_rho: float = 0.01
    fedprox_partial: float = 0.5   # fraction of local steps on limited devices
    # fedopt (server-side Adam on the aggregated pseudo-gradient)
    server_lr: float = 0.1
    server_b1: float = 0.9
    server_b2: float = 0.99
    server_tau: float = 1e-3
    # route every strategy's mix step through the fused Pallas ama_mix
    # kernel (interpret-mode off-TPU; see repro.kernels.ops). Applies to
    # the LEGACY aggregate() path only; the round engine dispatches the
    # fused server plane below.
    use_kernel: bool = False
    # the server-plane implementation the round engine dispatches
    # (core.round.make_round_step -> ServerStrategy.fused_server_update):
    #   "fused" — one hand-written CUDA kernel per round per dtype group
    #             on a CUDA tensor, its plain PyTorch version on a CPU one
    #   "ref"   — always the plain PyTorch version (kernels/ref.py)
    server_plane: str = "fused"
    # compressed client->server uplink (repro.comm registry):
    #   "none" — dense full-precision deltas (bit-identical legacy path)
    #   "bf16" — deltas cast to bfloat16 (2x, exact error feedback)
    #   "q8"   — stochastic-rounded int8 + per-cohort scale (~4x)
    #   "topk" — top-k magnitude sparsification ((value, index) pairs)
    # The bandwidth environment's deadline check and the extended
    # metrics' bytes_on_wire_compressed consume the ACTUAL compressed
    # payload size, so delay tolerance becomes a function of the plane.
    comm_plane: str = "none"
    comm_topk_frac: float = 0.01   # topk: surviving fraction per dtype group
    comm_error_feedback: bool = True  # carry the EF residual (aux["comm"])
    # the client-plane execution mode for MIXED (limited x unlimited)
    # cohorts (core.round.make_round_step; ``fes_static`` below is the
    # third, all-limited mode):
    #   "masked"      — ONE program for every cohort; limited cohorts
    #                   compute the full body backward and mask it (the
    #                   bit-identity reference under the chunked scan)
    #   "partitioned" — group each round's cohorts by limited-ness at
    #                   the staging layer and dispatch two vmapped
    #                   programs: the masked program for the unlimited
    #                   group and a classifier-only / statically
    #                   truncated program for the limited group (the
    #                   body backward is never traced — the paper's
    #                   Eq. 3 computation reduction for real)
    client_plane: str = "masked"
    fes_static: bool = False       # ALL cohorts computing-limited: classifier-
                                   # only differentiation (the body backward is
                                   # never built — paper §III at pod scale)
    fes_enabled: bool = True
    # telemetry plane (repro.obs): emit the extended per-round metric
    # series (staleness histogram, participation counts, effective mix
    # coefficient, delta/update norms, bytes-on-wire) as extra scan ys.
    # Opt-in; enabling it never changes the params stream (bit-identity
    # gated in tests/test_obs.py). The launcher switches it on with
    # --metrics-out.
    extended_metrics: bool = False
    seed: int = 0
    # pod-scale runs: #parallel client cohorts simulated in one jitted round
    cohorts: int = 4
    local_steps: int = 1           # grad steps per cohort per round (pod-scale)

    def with_(self, **kw) -> "FLConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **kw) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    small = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        train_fsdp=False,
        serve_2d=False,
    )
    if cfg.num_heads:
        small["num_heads"] = min(cfg.num_heads, 4)
        small["num_kv_heads"] = max(1, min(cfg.num_kv_heads, 2))
        small["head_dim"] = 64
    if cfg.num_experts:
        small["num_experts"] = min(cfg.num_experts, 4)
    if cfg.ssm_state:
        small["ssm_state"] = min(cfg.ssm_state, 16)
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
        small["encoder_seq"] = min(cfg.encoder_seq, 64)
    if cfg.num_patches:
        small["num_patches"] = min(cfg.num_patches, 16)
        small["vision_dim"] = min(cfg.vision_dim or cfg.d_model, 128)
    if cfg.sliding_window:
        small["sliding_window"] = min(cfg.sliding_window, 64)
    if cfg.attn_every:
        small["attn_every"] = 2
    small["fes_tail_layers"] = 1
    small.update(kw)
    return cfg.with_(**small)
