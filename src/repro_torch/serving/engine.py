"""Per-model serving engines with slot-based continuous batching.

``ModelEngine`` runs a real PyTorch model over a (max_batch,)-slot KV
cache with *per-slot lengths*.  Prompts run as **chunked prefill**: each
engine tick feeds every prefilling slot up to ``prefill_chunk`` prompt
tokens through one chunk-step (in-flight decode slots ride along with one
token each, so continuous batching never stalls), then greedy decode runs
one token per tick through the cheaper ``serve_step`` until
EOS/max_new_tokens.  A long prompt therefore reaches its first token in
~len/chunk ticks instead of len ticks.

Engines report per-query energy (Wh) via the analytic H100 model
(core.energy) — the zeus stand-in — and time-resolved per-step joules,
split by phase (prefill is compute-bound, decode bandwidth-bound).

Recurrent layouts (rwkv, mamba_hybrid) and windowed caches (a dense
sliding-window or local:global stack at ``max_len`` > its window keeps
ring buffers, no ``k`` entry) have no full-depth positional KV cache to
take a slab at an offset, so their prompts run token-wise through
``serve_step`` ("decode" ticks: ``set_prefill_chunk`` clamps the chunk to
1).  The engine's lengths are per slot, so its decode attends through the
plain ``decode_attend`` and the rings, never the decode-attention kernel
(which takes one length for every row), as in the JAX package.  Their cache holds per-slot state (``shift_tm``/``shift_cm``/``wkv``,
or ``conv``/``ssm`` plus the shared block's per-site KV) beside
``length``; the engine's own bookkeeping (``_admit``, ``_should_finish``,
``_meter_step``, ``_finish``) reads only ``length`` and request progress,
so it runs on either kind of cache.  As in the JAX package, admission
resets only ``length``: a recurrent slot keeps the previous request's
state, and idle slots feed token 0 through ``serve_step`` and drift.
That is a fault of the reference, reproduced on purpose so both packages
generate the same tokens (ROADMAP C).

This slice serves unified engines: prefix-KV splice/capture and the
disaggregated prefill/decode roles wait for the port's cache and
disaggregation slices, and the paper-scale ``SimEngine`` for its
paper-scale slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.energy import (CostModelParams, EnergyMonitor,
                                     JOULES_PER_WH, chunk_rider_cost,
                                     decode_step_cost, energy_joules,
                                     prefill_chunk_cost, prefill_cost,
                                     roofline)
from repro_torch.core.types import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.request import Request, RequestState, Response


class EngineFailure(RuntimeError):
    pass


class BaseEngine:
    """Interface shared by the engines."""

    name: str
    profile: ModelProfile

    def submit(self, req: Request) -> None:
        """Enqueue one routed request (admitted into a slot on a later step)."""
        raise NotImplementedError

    def submit_many(self, reqs: List[Request]) -> None:
        """Enqueue an already-routed batch slice in arrival order."""
        for req in reqs:
            self.submit(req)

    def step(self) -> List[Response]:
        """Advance the engine one tick; returns requests finished this tick."""
        raise NotImplementedError

    @property
    def pending(self) -> int:
        """Queued + in-slot request count (the scheduler's load signal)."""
        raise NotImplementedError

    @property
    def free_capacity(self) -> int:
        """Slots the engine could admit into right now (continuous-batching
        admission signal; 0 = saturated)."""
        return max(0, 1 - self.pending)

    def modeled_time_s(self) -> float:
        """Cumulative modeled seconds of engine compute (per-tick roofline
        ``t_step`` summed)."""
        return 0.0

    def set_prefill_chunk(self, n: int) -> None:
        """Prompt tokens consumed per prefill tick (1 = token-wise path)."""

    def cumulative_joules(self) -> float:
        """Cumulative metered energy in joules."""
        return 0.0

    def cumulative_joules_by_phase(self) -> Dict[str, float]:
        """Cumulative metered joules split by serving phase ("prefill" /
        "decode"); the values sum to ``cumulative_joules()``."""
        return {"prefill": 0.0, "decode": self.cumulative_joules()}

    # -- fault-tolerance hooks -------------------------------------------------

    def heartbeat(self) -> float:
        """Monotonic seconds timestamp of the last completed step."""
        return getattr(self, "_last_step_s", 0.0)

    def inject_failure(self) -> None:
        self._failed = True

    def restart(self) -> List[Request]:
        """Reset engine state; returns in-flight requests for re-queueing."""
        raise NotImplementedError


class ModelEngine(BaseEngine):
    """Real-model engine: continuous batching over a slotted cache.

    ``prefill_chunk`` sets how many prompt tokens each prefilling slot
    consumes per tick (1 = token-wise path; the launcher default is 8).
    ``device`` is where the model, the cache and every tick run (the card
    unless the caller passes ``device="cpu"``).  The cache is updated in
    place each tick (the JAX package donates it to its jitted steps).
    ``nonfinite_ticks`` counts ticks whose next-token logits held a NaN or
    an infinity (read back with the tokens, in the same transfer).
    ``tick_counts``, ``tick_seconds`` and ``decode_tokens`` are kept per
    tick kind ("chunk", "decode"): ticks run, host seconds spent in them
    (each tick ends in that device→host read, so the clock covers its
    device work), and tokens generated by slots already decoding (a
    prompt's first token is prefill's, not counted).
    """

    def __init__(self, name: str, cfg: ModelConfig, seed: int = 0,
                 max_batch: int = 4, max_len: int = 256,
                 params=None, detokenize: Optional[Callable] = None,
                 prefill_chunk: int = 1, device=None):
        self.name = name
        self.cfg = dataclasses.replace(cfg, kv_update="where")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.params = params if params is not None else api.init_params(
            self.cfg, seed, self.device)
        self.cache = api.init_cache(self.cfg, max_batch, max_len, self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.detokenize = detokenize or (lambda toks: "")
        self._failed = False
        self._last_step_s = time.monotonic()
        self.energy = EnergyMonitor()
        # per-step metered joules by serving phase
        self._phase_joules = {"prefill": 0.0, "decode": 0.0}
        self.cost_params = CostModelParams(
            n_params=float(cfg.param_count()),
            n_active_params=float(cfg.active_param_count()),
            d_model=cfg.d_model, n_layers=cfg.n_layers,
            kv_heads=max(cfg.n_kv_heads, 1), head_dim=cfg.head_dim)
        self.profile = ModelProfile(
            name=name, family=cfg.layout,
            params_b=cfg.param_count() / 1e9, arch_config=cfg)
        self.n_steps = 0
        self.nonfinite_ticks = 0
        self.tick_counts = {"chunk": 0, "decode": 0}
        self.tick_seconds = {"chunk": 0.0, "decode": 0.0}
        self.decode_tokens = {"chunk": 0, "decode": 0}
        self.prefill_chunk = 1
        self.set_prefill_chunk(prefill_chunk)
        self._modeled_time_s = 0.0

    def set_prefill_chunk(self, n: int) -> None:
        """Set the prompt tokens consumed per prefill tick.  Clamped to 1
        when the architecture can't take a slab at an offset."""
        n = max(int(n), 1)
        if not (api.supports_chunked_prefill(self.cfg) and "k" in self.cache):
            n = 1
        self.prefill_chunk = n

    def _read_next(self, last_logits: torch.Tensor) -> np.ndarray:
        """Greedy next tokens (B,) from (B, V) logits — ties to the lowest
        index, as ``jnp.argmax`` — plus a finiteness check, read back in
        one device→host transfer."""
        nxt = torch.argmax(last_logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(last_logits).all().to(torch.int32)
        out = torch.cat([nxt, finite.view(1)]).cpu().numpy()
        if not out[-1]:
            self.nonfinite_ticks += 1
        return out[:-1]

    def modeled_time_s(self) -> float:
        return self._modeled_time_s

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(s is not None for s in self.slots)

    @property
    def free_capacity(self) -> int:
        return max(0, self.max_batch - len(self.queue)
                   - sum(s is not None for s in self.slots))

    # -- queueing ----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.model_name = self.name
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                if req.defunct:
                    continue
                req.slot = i
                self.slots[i] = req
                # reset the slot's cache length so it starts fresh (only
                # the length, as the reference: recurrent state carries over)
                self.cache["length"][i] = 0
                req.state = RequestState.PREFILL
                req.start_s = time.monotonic()

    # -- the continuous-batching step ---------------------------------------------

    def step(self) -> List[Response]:
        """One engine tick.  Runs the chunk-step when any slot still has
        prompt tokens pending (and chunking is enabled), otherwise the
        cheaper one-token decode step.  Returns the requests that finished
        this tick."""
        if self._failed:
            raise EngineFailure(f"engine {self.name} failed")
        self._admit()
        self._last_step_s = time.monotonic()
        if not any(self.slots):
            return []
        live = [req for req in self.slots
                if req is not None and not req.defunct]
        need_prefill = any(not req.prefill_done for req in live)
        kind = ("chunk" if self.prefill_chunk > 1 and need_prefill
                else "decode")
        decoding = sum(req.prefill_done for req in live)  # one token each
        t0 = time.perf_counter()
        done = (self._chunk_tick() if kind == "chunk"
                else self._decode_tick())
        self.tick_seconds[kind] += time.perf_counter() - t0
        self.tick_counts[kind] += 1
        self.decode_tokens[kind] += decoding
        return done

    def _decode_tick(self) -> List[Response]:
        """One-token tick: every live slot feeds one token (next prompt
        token while prefilling, last generated token while decoding)
        through ``serve_step``."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if not req.prefill_done:
                tokens[i, 0] = req.prompt_tokens[req.n_prompt_fed]
            else:
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt_tokens[-1])
        logits, self.cache = api.serve_step(
            self.params, torch.from_numpy(tokens).to(self.device), self.cache,
            self.cfg)
        next_tok = self._read_next(logits[:, 0])
        self.n_steps += 1
        # token-wise prefill runs the decode step, so it costs a decode
        # step — but it is still prefill work, tagged as such
        self._meter_step([
            ("prefill" if not req.prefill_done else "decode", 1,
             max(req.n_prompt_fed + len(req.generated), 1))
            for req in self.slots
            if req is not None and not req.defunct])
        fed_prompt = [0 if (req is None or req.prefill_done) else 1
                      for req in self.slots]
        return self._advance_slots(next_tok, fed_prompt)

    def _chunk_tick(self) -> List[Response]:
        """Chunked-prefill tick: prefilling slots consume up to
        ``prefill_chunk`` prompt tokens, decode slots ride along with one
        token each (continuous batching never stalls), all in one
        chunk-step."""
        C = self.prefill_chunk
        tokens = np.zeros((self.max_batch, C), np.int32)
        n_active = np.zeros((self.max_batch,), np.int32)
        fed_prompt = [0] * self.max_batch
        meter = []
        for i, req in enumerate(self.slots):
            if req is None or req.defunct:
                continue
            kv_start = req.n_prompt_fed + len(req.generated)
            if not req.prefill_done:
                n = min(C, len(req.prompt_tokens) - req.n_prompt_fed)
                tokens[i, :n] = req.prompt_tokens[
                    req.n_prompt_fed:req.n_prompt_fed + n]
                n_active[i] = n
                fed_prompt[i] = n
                meter.append(("prefill", n, kv_start))
            else:
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt_tokens[-1])
                n_active[i] = 1
                # decode rider in a mixed tick: its row is chunk-padded
                # through the chunk step (see chunk_rider_cost)
                meter.append(("decode", 1, max(kv_start, 1), C))
        n_act = torch.from_numpy(n_active).to(self.device)
        logits, self.cache = api.prefill_chunk(
            self.params, torch.from_numpy(tokens).to(self.device), self.cache,
            self.cfg, n_act)
        # next token per slot from its last *active* position's logits
        idx = torch.clamp(n_act - 1, min=0).long()
        last = torch.gather(
            logits, 1, idx[:, None, None].expand(-1, 1, logits.shape[-1]))
        next_tok = self._read_next(last[:, 0])
        self.n_steps += 1
        self._meter_step(meter)
        return self._advance_slots(next_tok, fed_prompt)

    def _advance_slots(self, next_tok: np.ndarray,
                       fed_prompt: List[int]) -> List[Response]:
        """Shared post-step bookkeeping: advance prompt cursors, record
        TTFT at the first generated token, append decode tokens, finish
        on EOS / max_new_tokens / cache overflow."""
        finished: List[Response] = []
        now = time.monotonic()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.defunct:
                self.slots[i] = None
                continue
            if fed_prompt[i]:
                req.n_prompt_fed += fed_prompt[i]
                if req.prefill_done:
                    req.state = RequestState.DECODE
                    req.generated.append(int(next_tok[i]))
                    req.first_token_s = now
                    # the first generated token gets the same finish checks
                    # as any decode token — an EOS-first or 1-token-budget
                    # request must not survive into decode
                    if self._should_finish(i, req):
                        finished.append(self._finish(i))
                continue
            req.generated.append(int(next_tok[i]))
            if self._should_finish(i, req):
                finished.append(self._finish(i))
        return finished

    def _should_finish(self, slot: int, req: Request) -> bool:
        hit_eos = req.generated[-1] == req.eos_id
        full = len(req.generated) >= req.max_new_tokens
        overflow = int(self.cache["length"][slot]) >= self.max_len - 1
        return hit_eos or full or overflow

    def _meter_step(self, fed) -> None:
        """Accumulate this tick's modeled energy from the analytic cost
        model, split by phase.  ``fed`` lists (phase, n_tokens, kv_len)
        per live slot — plus a 4th ``pad`` element for decode riders in
        mixed chunk ticks: prefill slabs are charged
        ``prefill_chunk_cost`` (one weight read amortized over the slab),
        plain decode tokens ``decode_step_cost``, and padded riders
        ``chunk_rider_cost`` (the fused chunk kernel computes all ``pad``
        positions of the rider's row — the interference cost
        role-specialized engines avoid).  This is the time-resolved
        counterpart of ``measure_query`` (which stays the per-query Wh
        accounting of record).  No device sync: kv lengths come from
        request progress, not the cache.

        The same per-slot terms also advance the modeled tick-time ledger:
        one roofline ``t_step`` over the tick's aggregate FLOPs/bytes,
        with the per-slot weight read collapsed to a single read — the
        batched kernel streams the weights once per tick, so per-slot
        energy charges keep the read (each slot's query really pays for
        it) while tick *time* must not multiply it."""
        tick_flops, tick_bytes = 0.0, 0.0
        w_bytes = self.cost_params.n_active_params * self.cost_params.dtype_bytes
        for entry in fed:
            phase, n_tokens, kv_len = entry[:3]
            pad = entry[3] if len(entry) > 3 else 0
            if phase == "prefill" and n_tokens > 1:
                f, b = prefill_chunk_cost(self.cost_params, n_tokens, kv_len)
            elif pad > 1:
                f, b = chunk_rider_cost(self.cost_params, pad, max(kv_len, 1))
            else:
                f, b = decode_step_cost(self.cost_params, max(kv_len, 1))
            self._phase_joules[phase] += energy_joules(
                roofline(f, b, 0.0, self.energy.chips))
            tick_flops += f
            tick_bytes += b - w_bytes
        if fed:
            tick_bytes += w_bytes
            self._modeled_time_s += roofline(
                tick_flops, max(tick_bytes, 0.0), 0.0,
                self.energy.chips).t_step

    def cumulative_joules(self) -> float:
        return self._phase_joules["prefill"] + self._phase_joules["decode"]

    def cumulative_joules_by_phase(self) -> Dict[str, float]:
        return dict(self._phase_joules)

    def _finish(self, slot: int) -> Response:
        req = self.slots[slot]
        self.slots[slot] = None
        req.state = RequestState.DONE
        req.finish_s = time.monotonic()
        out = [t for t in req.generated if t != req.eos_id]
        pre_wh, dec_wh = self._query_wh(len(req.prompt_tokens), len(out))
        ttft_ms = ((req.first_token_s - req.submit_s) * 1e3
                   if req.first_token_s else 0.0)
        return Response(
            uid=req.uid, model_name=self.name, tokens=out,
            text=self.detokenize(out), latency_ms=req.latency_ms,
            queue_ms=(req.start_s - req.submit_s) * 1e3,
            energy_wh=pre_wh + dec_wh, input_tokens=len(req.prompt_tokens),
            output_tokens=len(out), hedged_winner=req.hedged,
            ttft_ms=ttft_ms, prefix_reused=req.prefix_reused,
            kv_migrated=req.kv_migrated, prefill_wh=pre_wh)

    def _query_wh(self, n_prompt: int, n_out: int) -> tuple:
        """Per-query (prefill Wh, decode Wh) of record; the sum is what
        ``measure_query`` charges.  The bandit feedback sees this spend."""
        f, b = prefill_cost(self.cost_params, max(n_prompt, 1))
        pre_j = energy_joules(roofline(f, b, 0.0, self.energy.chips))
        mid_kv = n_prompt + max(n_out, 1) // 2
        f, b = decode_step_cost(self.cost_params, mid_kv)
        dec_j = max(n_out, 0) * energy_joules(
            roofline(f, b, 0.0, self.energy.chips))
        # keep the monitor's totals coherent with measure_query's
        self.energy.total_joules += pre_j + dec_j
        self.energy.n_queries += 1
        return pre_j / JOULES_PER_WH, dec_j / JOULES_PER_WH

    def restart(self) -> List[Request]:
        # defunct (cancelled/timed-out/failed) requests are dropped, not
        # resurrected: resetting one to QUEUED would re-enter a terminal
        # uid into the scheduler's bookkeeping
        inflight = [r for r in ([r for r in self.slots if r is not None]
                                + self.queue)
                    if not r.defunct]
        for r in inflight:
            r.state = RequestState.QUEUED
            r.slot = -1
            r.generated = []
            r.n_prompt_fed = 0
            r.first_token_s = 0.0
        self.slots = [None] * self.max_batch
        self.queue = []
        self.cache = api.init_cache(self.cfg, self.max_batch, self.max_len,
                                    self.device)
        self._failed = False
        return inflight
