"""Serving engines: per-token loop and paged continuous batching (the
port of the JAX package's ``serve/engine.py``).

``LoopEngine`` is lockstep decode made correct for variable-length
prompts: every row feeds its OWN prompt token while it still has prompt
left and its last sampled token afterwards, so padded positions never
enter the KV cache. With ``prefill_chunk > 0`` (and a model exposing
``prefill``) the shared prompt prefix [0, min_len-1) is prefilled in
chunks, one call a chunk instead of one a token, bit-identically to the
per-token path. The audio family's cache is built from zero frame
embeddings (the frontend is a stub, as in JAX): the encoder runs once
when a batch starts, and every decoder layer's cross K/V with it.

``PagedEngine`` is the production plane: requests are admitted by the
FIFO token-budget ``Scheduler`` into fixed decode slots in WAVES (every
head-of-queue request that fits now), each wave's prompts chunk-prefilled
in lockstep straight into the shared ``KVPool``, and all active slots
decode in lockstep through ``decode_step_paged``. Finished requests free
their blocks between steps and the freed slot and blocks go to the next
admission: continuous batching. A request pays for its own ring
(ceil(ring / block_size) blocks), not the batch's largest.

Decode runs in bursts: under greedy decoding every completion time is
known in advance (len(generated) == max_new), so between scheduling
events the engine runs n decode steps (n a power of two, at most 32)
with the argmax fed back on the device, and reads the (n, S) tokens to
the host once a burst (JAX: one ``lax.scan`` of n steps).

Every latency span closes after a device sync (the host read of a step's
argmax, or an explicit synchronize), as ``obs.timing.sync_time`` does,
so per-request latency percentiles are honest. The engines run under
``torch.no_grad`` on the params' device, on ``model.serve_params`` of
the params they are given (made once, when the engine is built: the
audio family's padded ``lm_head``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.attention import PAD_POS
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.utils.tree import leaves


def latency_percentiles(seconds: list[float]) -> dict:
    if not seconds:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    a = np.asarray(seconds, np.float64) * 1e3
    return {f"p{q}_ms": round(float(np.percentile(a, q)), 2)
            for q in (50, 95, 99)}


def _result(req: Request) -> dict:
    return {
        "id": req.rid,
        "tokens": list(req.prompt) + [int(t) for t in req.generated],
        "new_tokens": len(req.generated),
        "queue_s": req.admit_t - req.submit_t,
        "prefill_s": req.prefill_s,
        "decode_s": req.done_t - req.admit_t - req.prefill_s,
        "total_s": req.done_t - req.submit_t,
    }


def _summary(results: list[dict], wall_s: float) -> dict:
    new = sum(r["new_tokens"] for r in results)
    return {"requests": len(results), "new_tokens": new,
            "wall_s": round(wall_s, 4),
            "tokens_per_s": round(new / wall_s, 2) if wall_s > 0 else 0.0,
            **latency_percentiles([r["total_s"] for r in results])}


def _ring_len(cfg, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LoopEngine:
    """Lockstep decode with per-request prompt lengths (+ optional
    chunked prefill of the shared prefix)."""

    def __init__(self, model, params, prefill_chunk: int = 0):
        self.model, self.params = model, model.serve_params(params)
        self.device = leaves(params)[0].device
        self.prefill_chunk = int(prefill_chunk) \
            if model.prefill is not None else 0
        self.last_summary: dict | None = None

    def _ids(self, a):
        return torch.tensor(a, dtype=torch.int32, device=self.device)

    def _init_cache(self, B: int, max_len: int):
        model, cfg = self.model, self.model.cfg
        if cfg.family == "audio":
            fe = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                             dtype=getattr(torch, cfg.dtype),
                             device=self.device)
            return model.init_decode_cache(self.params, fe, max_len)
        return model.init_decode_cache(self.params, B, max_len)

    @torch.no_grad()
    def run(self, requests: list[Request]) -> list[dict]:
        model, params = self.model, self.params
        reqs = list(requests)
        B = len(reqs)
        t_start = time.perf_counter()
        for r in reqs:
            r.submit_t = r.admit_t = t_start       # all admitted at once
            r.generated = []
        lens = [r.prompt_len for r in reqs]
        max_len = max(r.prompt_len + r.max_new for r in reqs) + 1
        cache = self._init_cache(B, max_len)

        t0 = 0
        if self.prefill_chunk:
            # chunked prefill of the SHARED prefix [0, min_len-1); per-row
            # prompt tails and generation stay in the token loop
            c = min(self.prefill_chunk, _ring_len(model.cfg, max_len))
            end = min(lens) - 1
            t_pf = time.perf_counter()
            while t0 < end:
                n = min(c, end - t0)
                toks = np.zeros((B, c), np.int32)
                poss = np.full((B, c), PAD_POS, np.int32)
                for b, r in enumerate(reqs):
                    toks[b, :n] = r.prompt[t0:t0 + n]
                poss[:, :n] = np.arange(t0, t0 + n, dtype=np.int32)
                _, cache = model.prefill(params, self._ids(toks),
                                         self._ids(poss), cache)
                t0 += n
            _sync(self.device)
            for r in reqs:
                r.prefill_s = time.perf_counter() - t_pf

        T = max(r.prompt_len + r.max_new for r in reqs) - 1
        tok = np.zeros((B,), np.int32)
        for t in range(t0, T):
            for b, r in enumerate(reqs):
                if t < lens[b]:
                    tok[b] = r.prompt[t]
                else:
                    tok[b] = r.generated[min(t - lens[b],
                                             len(r.generated) - 1)]
            logits, cache = model.decode_step(
                params, self._ids(tok), self._ids(np.full((B,), t)), cache)
            if t < min(lens) - 1:
                continue            # pure prefill: no row samples yet
            args = logits.argmax(-1).cpu().numpy()          # blocks
            now = time.perf_counter()
            for b, r in enumerate(reqs):
                if t >= lens[b] - 1 and len(r.generated) < r.max_new:
                    r.generated.append(int(args[b]))
                    if len(r.generated) == r.max_new:
                        r.done_t = now
        results = [_result(r) for r in reqs]
        self.last_summary = _summary(results, time.perf_counter() - t_start)
        return results


class PagedEngine:
    """Continuous batching over a shared paged KV pool (attention
    families only: the ssm and hybrid families have recurrent state, not
    a KV ring, and the audio family, as in JAX, serves by the loop
    engine)."""

    _MAX_BURST = 32

    def __init__(self, model, params, *, max_slots: int = 4,
                 block_size: int = 8, max_batch_tokens: int = 0,
                 prefill_chunk: int = 8, num_blocks: int | None = None):
        if model.prefill_paged is None:
            raise ValueError(
                f"family {model.cfg.family!r} has no paged serving path "
                f"(use LoopEngine)")
        self.model, self.params = model, model.serve_params(params)
        self.device = leaves(params)[0].device
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_batch_tokens = int(max_batch_tokens)
        self.prefill_chunk = int(prefill_chunk)
        self.num_blocks = num_blocks
        self.last_summary: dict | None = None
        self.scheduler: Scheduler | None = None
        self.kv: KVPool | None = None

    def _ids(self, a):
        return torch.tensor(a, dtype=torch.int32, device=self.device)

    def _burst(self, n: int, tok, pos, table, lw):
        """``n`` decode steps with on-device greedy feedback. Returns the
        sampled tokens (n, S) int32 on the device; the pool is updated in
        place."""
        step = self.model.decode_step_paged
        toks = []
        for _ in range(n):
            logits, _ = step(self.params, tok, pos, self.kv.pool, table, lw)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
            toks.append(tok)
        return torch.stack(toks)

    @torch.no_grad()
    def run(self, requests: list[Request]) -> list[dict]:
        cfg = self.model.cfg
        params = self.params
        reqs = list(requests)
        rings = {r.rid: _ring_len(cfg, r.prompt_len + r.max_new + 1)
                 for r in reqs}
        S = self.max_slots
        bs = self.block_size
        MB = max(-(-lw // bs) for lw in rings.values())
        NB = self.num_blocks or 1 + S * MB
        kv = self.kv = KVPool(self.model, NB, bs, self.device)
        sched = self.scheduler = Scheduler(self.max_batch_tokens)
        c = max(1, min(self.prefill_chunk, min(rings.values())))

        slot_rid: list[int | None] = [None] * S
        table = np.zeros((S, MB), np.int32)
        lw = np.ones((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        tok = np.zeros((S,), np.int32)
        blocks_of: dict[int, list[int]] = {}
        by_rid = {r.rid: r for r in reqs}

        t_start = time.perf_counter()
        for r in reqs:
            r.submit_t = t_start
            r.generated = []
            sched.submit(r)

        def can_place(req):
            return (None in slot_rid
                    and kv.can_alloc(kv.blocks_for(rings[req.rid])))

        def admit_all():
            # waves until the queue head no longer fits (a wave's own
            # max_new == 1 completions can free slots for the next wave)
            while admit_wave():
                pass

        def admit_wave() -> bool:
            # admit a WAVE: every head-of-queue request that fits right
            # now, then prefill the whole wave in lockstep chunks, one
            # call a chunk for the wave, not a request
            wave: list[tuple[int, Request]] = []
            while True:
                req = sched.try_admit(can_place=can_place)
                if req is None:
                    break
                s = slot_rid.index(None)
                nblk = kv.blocks_for(rings[req.rid])
                blocks_of[req.rid] = blocks = kv.alloc(nblk)
                slot_rid[s] = req.rid
                sched.record_slot(req.rid, s)
                table[s, :] = 0
                table[s, :nblk] = blocks
                lw[s] = rings[req.rid]
                req.admit_t = time.perf_counter()
                wave.append((s, req))
            if not wave:
                return False
            # chunked prefill into the shared pool. Rows that run out of
            # prompt before the wave's longest become all-PAD (no-op
            # writes); each row's first sampled token comes from the chunk
            # holding its last prompt position.
            W = len(wave)
            slots_w = [s for s, _ in wave]
            t_rows = self._ids(table[slots_w])
            l_rows = self._ids(lw[slots_w])
            maxP = max(r.prompt_len for _, r in wave)
            first_tok = {}
            for t0 in range(0, maxP, c):
                toks = np.zeros((W, c), np.int32)
                poss = np.full((W, c), PAD_POS, np.int32)
                for w, (_, r) in enumerate(wave):
                    n = min(c, r.prompt_len - t0)
                    if n > 0:
                        toks[w, :n] = r.prompt[t0:t0 + n]
                        poss[w, :n] = np.arange(t0, t0 + n, dtype=np.int32)
                logits, _ = self.model.prefill_paged(
                    params, self._ids(toks), self._ids(poss), kv.pool,
                    t_rows, l_rows)
                args = logits.argmax(-1).cpu().numpy()       # blocks
                for w, (_, r) in enumerate(wave):
                    last = r.prompt_len - 1 - t0
                    if 0 <= last < c:
                        first_tok[r.rid] = int(args[w, last])
            now = time.perf_counter()
            for s, req in wave:
                req.prefill_s = now - req.admit_t
                req.generated.append(first_tok[req.rid])
                pos[s] = req.prompt_len
                tok[s] = first_tok[req.rid]
                if len(req.generated) >= req.max_new:
                    finish(s, now)
            return True

        def finish(s, now):
            rid = slot_rid[s]
            req = by_rid[rid]
            req.done_t = now
            kv.free(blocks_of.pop(rid))
            sched.release(req)
            slot_rid[s] = None
            table[s, :] = 0
            lw[s] = 1
            pos[s] = 0
            tok[s] = 0

        results_order = [r.rid for r in reqs]
        admit_all()
        while any(s is not None for s in slot_rid) or sched.pending:
            if all(s is None for s in slot_rid):
                # nothing in flight yet the head cannot be placed: the
                # request cannot ever fit this pool
                req = sched.queue[0]
                raise RuntimeError(
                    f"request {req.rid} needs "
                    f"{kv.blocks_for(rings[req.rid])} blocks; pool has "
                    f"{kv.num_blocks - 1} total")
            # steps until the next scheduling event are known exactly
            # under greedy decoding: burst them
            to_event = min(by_rid[rid].max_new - len(by_rid[rid].generated)
                           for rid in slot_rid if rid is not None)
            n = 1
            while n * 2 <= min(to_event, self._MAX_BURST):
                n *= 2
            args = self._burst(n, self._ids(tok), self._ids(pos),
                               self._ids(table), self._ids(lw))
            args = args.cpu().numpy()                        # blocks
            now = time.perf_counter()
            for s in range(S):
                if slot_rid[s] is None:
                    continue
                req = by_rid[slot_rid[s]]
                req.generated.extend(int(t) for t in args[:, s])
                pos[s] += n
                tok[s] = int(args[-1, s])
                if len(req.generated) >= req.max_new:
                    finish(s, now)
            admit_all()

        results = [_result(by_rid[rid]) for rid in results_order]
        self.last_summary = _summary(results, time.perf_counter() - t_start)
        return results
