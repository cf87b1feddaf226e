"""Per-model serving engines with slot-based continuous batching.

Two backends behind one interface:

  * ``ModelEngine`` — a real PyTorch model (below);
  * ``SimEngine``   — a timing/energy/accuracy model of a pool member
    (the paper's 16-model pool has no weights here); used by the
    paper-scale replay (``repro_torch.benchmarks``).

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

Cross-query prefix-KV reuse (``set_prefix_cache``, GreenCache's prefix
layer): a dense or MoE engine splices the longest cached prompt prefix
into a newly admitted slot (host → card) and prefills only the suffix;
a finished prompt's whole blocks are captured (card → host) into the
engine's ``PrefixCache``.  The avoided prefill is credited on the
engine's ledger (``cumulative_joules_avoided``), never un-spent.

Disaggregated prefill/decode (``set_role``): a ``prefill`` engine hands a
request off at the phase boundary — its prompt KV copied out of the slot
(a copy on the engine's device, not a view: the slot is freed and
rewritten on the next tick), its prefill Wh stamped — into an outbox the
scheduler drains into the ``decode`` twin, which splices the KV into a
slot with the prefix splice's transport and decodes from there.  The
phase-boundary transfer is charged as ``kv_migration_cost`` on the
twin's prefill ledger.  The same full-depth positional-KV gate as
chunked prefill applies: recurrent and ring layouts stay ``unified``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache.prefix import PrefixCache
from repro_torch.core.energy import (CostModelParams, EnergyMonitor,
                                     JOULES_PER_WH, chunk_rider_cost,
                                     decode_step_cost, energy_joules,
                                     kv_migration_cost, prefill_chunk_cost,
                                     prefill_cost, roofline)
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
    role: str = "unified"    # "prefill" | "decode" | "unified"

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

    # -- prefill/decode disaggregation hooks ----------------------------------

    def set_role(self, role: str) -> None:
        """Specialize the engine: a ``prefill`` engine hands requests off at
        the phase boundary instead of decoding them; a ``decode`` engine
        accepts those migrations.  Engines that can't export/import KV
        (no full-depth positional cache) silently stay ``unified``."""

    def drain_migrations(self) -> List[Request]:
        """Requests that finished prefill this tick and carry a KV payload;
        the scheduler moves them to the decode twin.  Draining empties the
        outbox.  Always empty for unified/decode roles."""
        return []

    def submit_migrated(self, req: Request) -> None:
        """Enqueue a migrated request (``req.kv_payload`` holds its prompt
        KV); spliced into a slot on a later step, then decoded."""
        raise NotImplementedError(f"{self.name} cannot accept migrations")

    def modeled_time_s(self) -> float:
        """Cumulative modeled seconds of engine compute (per-tick roofline
        ``t_step`` summed)."""
        return 0.0

    def set_prefill_chunk(self, n: int) -> None:
        """Prompt tokens consumed per prefill tick (1 = token-wise path)."""

    def set_prefix_cache(self, cache: Optional[PrefixCache]) -> None:
        """Attach a ``PrefixCache`` for cross-query prompt-KV reuse.
        No-op for engines without a materialized KV cache; real engines
        override and gate on layout support."""

    def cumulative_joules(self) -> float:
        """Cumulative metered energy in joules."""
        return 0.0

    def cumulative_joules_by_phase(self) -> Dict[str, float]:
        """Cumulative metered joules split by serving phase ("prefill" /
        "decode"); the values sum to ``cumulative_joules()``."""
        return {"prefill": 0.0, "decode": self.cumulative_joules()}

    def cumulative_joules_avoided(self) -> float:
        """Cumulative modeled joules *not* spent thanks to prefix-KV
        reuse (the prefill work a spliced prefix replaced)."""
        return 0.0

    def prefix_hit_count(self) -> int:
        """Admissions that spliced a cached prefix."""
        return 0

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
    ``role`` is the engine's serving phase (``set_role``).
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
                 prefill_chunk: int = 1, role: str = "unified",
                 device=None):
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
        # cross-query prefix-KV reuse: attached by the scheduler's
        # _configure_engine; None = recompute every prompt
        self.prefix_cache: Optional[PrefixCache] = None
        self._avoided_joules = 0.0
        self._prefix_hits = 0
        # prefill/decode disaggregation: a "prefill" engine parks
        # phase-boundary requests here for the scheduler to move to the
        # decode twin
        self.role = "unified"
        self._migration_outbox: List[Request] = []
        self._migration_joules = 0.0
        self.set_role(role)

    def _full_depth_kv(self) -> bool:
        """The layout has a full-depth positional KV cache, which is what
        a chunk slab at an offset and a spliced prefix need."""
        return api.supports_chunked_prefill(self.cfg) and "k" in self.cache

    def set_role(self, role: str) -> None:
        """Pin the engine to one serving phase.  The same full-depth
        positional-KV gate as chunked prefill applies: the migration
        copies the slot's prompt KV out and splices it into the twin's
        slot, so recurrent (rwkv/mamba) and ring-buffer layouts silently
        fall back to ``unified`` and keep both phases local."""
        if role not in ("prefill", "decode", "unified"):
            raise ValueError(f"unknown engine role {role!r}")
        if role != "unified" and not self._full_depth_kv():
            role = "unified"
        self.role = role

    def set_prefill_chunk(self, n: int) -> None:
        """Set the prompt tokens consumed per prefill tick.  Clamped to 1
        when the architecture can't take a slab at an offset."""
        n = max(int(n), 1)
        if not self._full_depth_kv():
            n = 1
        self.prefill_chunk = n

    def set_prefix_cache(self, cache: Optional[PrefixCache]) -> None:
        """Attach (or detach, with None) a prefix-KV cache.  Only layouts
        whose decode cache can take a spliced slab participate — the same
        full-depth positional-KV gate as chunked prefill; ring-buffer and
        recurrent layouts silently keep recomputing their prompts."""
        if cache is not None and not self._full_depth_kv():
            cache = None
        self.prefix_cache = cache

    def cumulative_joules_avoided(self) -> float:
        return self._avoided_joules

    def prefix_hit_count(self) -> int:
        return self._prefix_hits

    def _prefill_joules(self, n_tokens: int, kv_start: int = 0) -> float:
        """Modeled joules the engine would spend prefilling ``n_tokens``
        prompt tokens starting at cache offset ``kv_start`` at its current
        chunk setting (``_meter_step``'s charging rule: slabs > 1 token
        cost ``prefill_chunk_cost``, single tokens ``decode_step_cost``).
        With kv_start=0 this is the exact work a spliced prefix of that
        length avoids; with kv_start=p it is the work the uncached suffix
        still costs."""
        C = max(self.prefill_chunk, 1)
        joules, kv = 0.0, kv_start
        end = kv_start + n_tokens
        while kv < end:
            n = min(C, end - kv)
            if n > 1:
                f, b = prefill_chunk_cost(self.cost_params, n, kv)
            else:
                f, b = decode_step_cost(self.cost_params, max(kv + n, 1))
            joules += energy_joules(roofline(f, b, 0.0, self.energy.chips))
            kv += n
        return joules

    def estimate_prefill_wh(self, n_tokens: int) -> float:
        """Expected Wh saved by an ``n_tokens`` prefix hit (the router
        discount's units)."""
        return self._prefill_joules(n_tokens) / JOULES_PER_WH

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
        return (len(self.queue) + len(self._migration_outbox)
                + sum(s is not None for s in self.slots))

    @property
    def free_capacity(self) -> int:
        return max(0, self.max_batch - len(self.queue)
                   - sum(s is not None for s in self.slots))

    # -- queueing ----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.model_name = self.name
        self.queue.append(req)

    def submit_migrated(self, req: Request) -> None:
        """Accept a phase-boundary migration from the prefill twin.  The
        request keeps its prompt cursor (fully fed), its first generated
        token, and its stamped ``prefill_wh``; ``_admit`` splices the KV
        payload into a slot and decode continues from there."""
        self.queue.append(req)

    def drain_migrations(self) -> List[Request]:
        out, self._migration_outbox = self._migration_outbox, []
        return out

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
                if req.kv_payload is not None:
                    self._splice_migration(i, req)
                    continue
                req.state = RequestState.PREFILL
                req.start_s = time.monotonic()
                if self.prefix_cache is not None:
                    self._splice_prefix(i, req)

    def _splice_migration(self, slot: int, req: Request) -> None:
        """Land a migrated request: splice its carried prompt KV into the
        slot (cache length = prompt length, exactly the state the prefill
        twin left behind) and charge the migration transfer to the prefill
        ledger — it is phase-boundary overhead, not decode work."""
        k_blk, v_blk = req.kv_payload
        self.cache = api.splice_prefix(self.cache, slot, k_blk, v_blk)
        req.kv_payload = None
        req.state = RequestState.DECODE
        f, b = kv_migration_cost(self.cost_params, req.kv_migrated)
        terms = roofline(f, b, 0.0, self.energy.chips)
        joules = energy_joules(terms)
        self._migration_joules += joules
        self._phase_joules["prefill"] += joules
        self._modeled_time_s += terms.t_step

    def _splice_prefix(self, slot: int, req: Request) -> None:
        """Reuse the longest cached KV prefix for a newly admitted prompt.

        Keeps >= 1 prompt token to feed (the final token's forward pass
        produces the first-generation logits), so the cap is
        ``len(prompt) - 1``.  The splice (host → card) sets the slot
        length to the reused depth; prefill then continues from that
        offset, and the avoided prefill work is credited to the engine's
        avoided-joules ledger."""
        p, k_blk, v_blk = self.prefix_cache.match(
            req.prompt_tokens, max_tokens=len(req.prompt_tokens) - 1)
        if p <= 0:
            return
        self.cache = api.splice_prefix(self.cache, slot, k_blk, v_blk)
        req.n_prompt_fed = p
        req.prefix_reused = p
        self._prefix_hits += 1
        self._avoided_joules += self._prefill_joules(p)

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
        on EOS / max_new_tokens / cache overflow.  On a ``prefill``-role
        engine, requests that survive the finish checks at the phase
        boundary are handed to the migration outbox instead of decoding
        locally."""
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
                    # request must not survive into decode (or migrate)
                    if self._should_finish(i, req):
                        finished.append(self._finish(i))
                    elif self.role == "prefill":
                        self._emit_migration(i, req)
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

    def _emit_migration(self, slot: int, req: Request) -> None:
        """Phase boundary on a prefill-role engine: copy the prompt KV out
        of the slot (a copy on the engine's device — the slot is freed
        here and rewritten on the next tick, so a view would be
        overwritten), stamp the metered prefill-phase Wh on the request,
        and free the slot for the next arrival.  Prompts that overflowed
        the slot cache have unwritten KV positions — nothing trustworthy
        to ship — so they stay local and decode here (per-request unified
        fallback)."""
        n_p = len(req.prompt_tokens)
        if n_p > self.max_len - 1:
            return
        k = self.cache["k"][:, slot, :n_p].clone()
        v = self.cache["v"][:, slot, :n_p].clone()
        req.kv_payload = (k, v)
        req.kv_migrated = n_p
        req.prefill_wh = self._prefill_phase_wh(req)
        req.state = RequestState.MIGRATING
        req.slot = -1
        self._migration_outbox.append(req)
        self.slots[slot] = None

    def _prefill_phase_wh(self, req: Request) -> float:
        """The prefill share of the per-query Wh of record, stamped at
        migration time by the engine that actually did the work.  Mirrors
        ``_query_wh``'s split: cold prompts cost ``measure_query``'s
        prefill term, spliced prompts only their uncached suffix.  The
        spend is charged to this engine's monitor now — a later decode-twin
        failure re-queues the request but never un-spends these joules."""
        n_p = max(len(req.prompt_tokens), 1)
        if req.prefix_reused > 0:
            joules = self._prefill_joules(max(n_p - req.prefix_reused, 1),
                                          kv_start=req.prefix_reused)
        else:
            f, b = prefill_cost(self.cost_params, n_p)
            joules = energy_joules(roofline(f, b, 0.0, self.energy.chips))
        self.energy.total_joules += joules
        return joules / JOULES_PER_WH

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
        self._capture_prefix(slot, req)
        self.slots[slot] = None
        req.state = RequestState.DONE
        req.finish_s = time.monotonic()
        out = [t for t in req.generated if t != req.eos_id]
        if req.kv_migrated and req.prefill_wh > 0:
            pre_wh, dec_wh = self._migrated_query_wh(req, len(out))
        else:
            pre_wh, dec_wh = self._query_wh(len(req.prompt_tokens),
                                            req.prefix_reused, len(out))
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

    def _query_wh(self, n_prompt: int, reused: int, n_out: int) -> tuple:
        """Per-query (prefill Wh, decode Wh) of record; the sum is what
        ``measure_query`` charges.  Cold queries keep its terms exactly.
        With a spliced prefix, the prefill term covers only the uncached
        suffix (charged at its true cache offsets) while decode is still
        charged at *full* context depth — prefix reuse avoids prefill
        work, never decode work.  The bandit feedback sees this spend."""
        if reused <= 0:
            f, b = prefill_cost(self.cost_params, max(n_prompt, 1))
            pre_j = energy_joules(roofline(f, b, 0.0, self.energy.chips))
        else:
            pre_j = self._prefill_joules(max(n_prompt - reused, 1),
                                         kv_start=reused)
        mid_kv = n_prompt + max(n_out, 1) // 2
        f, b = decode_step_cost(self.cost_params, mid_kv)
        dec_j = max(n_out, 0) * energy_joules(
            roofline(f, b, 0.0, self.energy.chips))
        # keep the monitor's totals coherent with measure_query's
        self.energy.total_joules += pre_j + dec_j
        self.energy.n_queries += 1
        return pre_j / JOULES_PER_WH, dec_j / JOULES_PER_WH

    def _migrated_query_wh(self, req: Request, n_out: int) -> tuple:
        """Per-query (prefill Wh, decode Wh) of record for a request that
        prefilled elsewhere: the prefill twin's stamped ``prefill_wh`` +
        the phase-boundary KV transfer on the prefill side, this engine's
        decode work at full context depth on the decode side.  The prefill
        term was already charged to the twin's monitor at migration
        time."""
        n_prompt = len(req.prompt_tokens)
        mid_kv = n_prompt + max(n_out, 1) // 2
        f, b = decode_step_cost(self.cost_params, mid_kv)
        dec_j = max(n_out, 0) * energy_joules(
            roofline(f, b, 0.0, self.energy.chips))
        f, b = kv_migration_cost(self.cost_params, req.kv_migrated)
        mig_j = energy_joules(roofline(f, b, 0.0, self.energy.chips))
        self.energy.total_joules += dec_j + mig_j
        self.energy.n_queries += 1
        return (req.prefill_wh + mig_j / JOULES_PER_WH,
                dec_j / JOULES_PER_WH)

    def _capture_prefix(self, slot: int, req: Request) -> None:
        """Register a finished prompt's KV with the prefix cache.  The
        prompt region [0, n_prompt) of the slot cache is still intact at
        finish time (decode appends strictly after it), so the capture is
        one card → host copy of k and v in the cache's dtype; whole blocks
        only (tail rounding lives in ``PrefixCache.insert``)."""
        n_p = len(req.prompt_tokens)
        if (self.prefix_cache is None
                or n_p < self.prefix_cache.block_tokens
                or req.n_prompt_fed < n_p
                or n_p > self.max_len - 1):
            # the last guard: a prompt that overflowed the slot cache has
            # KV positions >= max_len that were never written — nothing
            # trustworthy to capture
            return
        k = self.cache["k"][:, slot, :n_p].to("cpu")
        v = self.cache["v"][:, slot, :n_p].to("cpu")
        self.prefix_cache.insert(req.prompt_tokens, k, v)

    def restart(self) -> List[Request]:
        # defunct (cancelled/timed-out/failed) requests are dropped, not
        # resurrected: resetting one to QUEUED would re-enter a terminal
        # uid into the scheduler's bookkeeping
        inflight = [r for r in ([r for r in self.slots if r is not None]
                                + self.queue + self._migration_outbox)
                    if not r.defunct]
        for r in inflight:
            r.state = RequestState.QUEUED
            r.slot = -1
            r.generated = []
            r.n_prompt_fed = 0
            r.prefix_reused = 0          # re-splices on re-admission
            r.first_token_s = 0.0
            # drop any in-transit KV: it is re-prefilled from scratch, and
            # the twin's already-charged joules stay spent (never refunded)
            r.kv_payload = None
            r.kv_migrated = 0
            r.prefill_wh = 0.0
        self.slots = [None] * self.max_batch
        self.queue = []
        self._migration_outbox = []
        self.cache = api.init_cache(self.cfg, self.max_batch, self.max_len,
                                    self.device)
        self._failed = False
        return inflight


class SimEngine(BaseEngine):
    """Pool-member simulator: latency/energy/accuracy from profiles.

    Used by the paper-scale benchmarks (16 models × 2500 queries in
    seconds).  ``outcome_fn(query, model_name) -> (accuracy, energy_wh,
    latency_ms, out_tokens)`` encapsulates the calibrated behaviour tables
    (repro_torch.data.profiles).

    A cheap twin of ``ModelEngine`` for everything the scheduler observes:

      * ``concurrency`` mirrors the slot semantics: up to that many queued
        requests make progress each step, and ``free_capacity`` reports
        the unused slots so ``PoolServer.enqueue`` continuous batching
        admits at the pool's real parallelism;
      * ``clock`` injects the time source so ``start_s``/``finish_s``/
        heartbeats can live on a virtual clock instead of mixing wall and
        modeled time;
      * energy is phase-split: each completion's Wh divides into prefill
        vs decode by per-token weights mirroring the calibrated tables'
        marginal costs, feeding ``cumulative_joules_by_phase`` and
        ``Response.prefill_wh`` like the real engine;
      * prefix-KV reuse is modeled with the *real* ``PrefixCache`` radix
        trie (token-level matching, LRU eviction) — a hit discounts the
        avoided prefill share from the query's spend and credits the
        avoided-joules ledger, never un-spending energy;
      * ``modeled_time_s`` advances by the slowest active request's
        per-step latency share, so virtual-clock drives can diff it.
    """

    # prefill/decode per-token Wh weights for the phase split; the ratio
    # mirrors repro_torch.data.profiles' marginal costs (MWH_PER_B_PER_IN_TOKEN
    # vs MWH_PER_B_PER_OUT_TOKEN), kept literal to avoid a data-layer dep
    PREFILL_TOKEN_WEIGHT = 0.002
    DECODE_TOKEN_WEIGHT = 0.15

    def __init__(self, profile: ModelProfile, outcome_fn,
                 steps_per_query: int = 1, concurrency: int = 1,
                 clock: Optional[Callable[[], float]] = None):
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        self.name = profile.name
        self.profile = profile
        self.outcome_fn = outcome_fn
        self.queue: List[Request] = []
        self.steps_per_query = steps_per_query
        self.concurrency = concurrency
        self.clock = clock or time.monotonic
        self._failed = False
        self._last_step_s = self.clock()
        self._progress: Dict[int, int] = {}
        # outcome drawn once at first service step (slot activation) and
        # held until completion, so latency can pace the modeled clock
        self._outcomes: Dict[int, tuple] = {}
        self._phase_joules = {"prefill": 0.0, "decode": 0.0}
        self._modeled_time_s = 0.0
        self.prefix_cache: Optional[PrefixCache] = None
        self._avoided_joules = 0.0
        self._prefix_hits = 0
        # EWMA of observed cold prefill Wh per prompt token, backing
        # estimate_prefill_wh (a cold engine offers no discount)
        self._prefill_wh_per_token: Optional[float] = None

    def submit(self, req: Request) -> None:
        req.model_name = self.name
        self.queue.append(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def free_capacity(self) -> int:
        return max(0, self.concurrency - len(self.queue))

    def set_prefix_cache(self, cache: Optional[PrefixCache]) -> None:
        """Attach a PrefixCache; the sim models a full-depth positional KV
        layout, so there is no layout gate."""
        self.prefix_cache = cache

    def cumulative_joules(self) -> float:
        return self._phase_joules["prefill"] + self._phase_joules["decode"]

    def cumulative_joules_by_phase(self) -> Dict[str, float]:
        return dict(self._phase_joules)

    def cumulative_joules_avoided(self) -> float:
        return self._avoided_joules

    def prefix_hit_count(self) -> int:
        return self._prefix_hits

    def modeled_time_s(self) -> float:
        return self._modeled_time_s

    def estimate_prefill_wh(self, n_tokens: int) -> float:
        """Expected Wh an ``n_tokens`` prefix hit saves, from the observed
        per-token prefill EWMA (0 until the first completion calibrates it
        — a cold cache offers no routing discount)."""
        return (self._prefill_wh_per_token or 0.0) * max(n_tokens, 0)

    def _phase_split(self, n_in: int, n_out: int) -> float:
        """Prefill fraction of a completion's energy, by token-weighted
        marginal cost (the fixed overhead splits proportionally)."""
        pre = max(n_in, 0) * self.PREFILL_TOKEN_WEIGHT
        dec = max(n_out, 1) * self.DECODE_TOKEN_WEIGHT
        return pre / max(pre + dec, 1e-12)

    def _activate(self, req: Request) -> tuple:
        """First service step for a request: stamp start, probe the prefix
        cache (the modeled splice — ``match`` LRU-touches the chain like a
        real admission), and draw + pin the outcome."""
        if req.start_s == 0.0:
            req.start_s = self.clock()
        outcome = self._outcomes.get(req.uid)
        if outcome is None:
            if (self.prefix_cache is not None and req.prefix_reused == 0
                    and len(req.prompt_tokens) > 1):
                p, _, _ = self.prefix_cache.match(
                    req.prompt_tokens, max_tokens=len(req.prompt_tokens) - 1)
                if p > 0:
                    req.prefix_reused = p
                    self._prefix_hits += 1
            # state stays QUEUED while in service (a sim "slot" has no
            # prefill/decode sub-lifecycle), so a slow head-of-queue
            # request is still hedgeable, as on the real engine
            outcome = self.outcome_fn(req.query, self.name)
            self._outcomes[req.uid] = outcome
        return outcome

    def _finish(self, req: Request, outcome: tuple) -> Response:
        acc, energy_wh, latency_ms, out_tokens = outcome
        n_in = len(req.prompt_tokens)
        pre_wh_cold = energy_wh * self._phase_split(n_in, out_tokens)
        dec_wh = energy_wh - pre_wh_cold
        avoided_wh = 0.0
        if req.prefix_reused > 0 and n_in > 0:
            # the spliced share of the prompt was never prefilled: its
            # energy is avoided (credited, not un-spent) and the query's
            # Wh of record covers only the uncached suffix + decode
            avoided_wh = pre_wh_cold * min(req.prefix_reused / n_in, 1.0)
            self._avoided_joules += avoided_wh * JOULES_PER_WH
        pre_wh = pre_wh_cold - avoided_wh
        self._phase_joules["prefill"] += pre_wh * JOULES_PER_WH
        self._phase_joules["decode"] += dec_wh * JOULES_PER_WH
        if n_in > 0:
            sample = pre_wh_cold / n_in
            self._prefill_wh_per_token = (
                sample if self._prefill_wh_per_token is None
                else 0.8 * self._prefill_wh_per_token + 0.2 * sample)
        if (self.prefix_cache is not None
                and n_in >= self.prefix_cache.block_tokens):
            # register the completed prompt; the sim has no real KV, so
            # placeholder blocks stand in (matching is token-exact either
            # way, and capacity/eviction behave like the real pool)
            kv = torch.zeros((1, n_in, 1, 1), dtype=torch.float32)
            self.prefix_cache.insert(req.prompt_tokens, kv, kv)
        req.state = RequestState.DONE
        req.finish_s = self.clock()
        resp = Response(
            uid=req.uid, model_name=self.name, tokens=[], text="",
            latency_ms=latency_ms,
            queue_ms=(req.start_s - req.submit_s) * 1e3,
            energy_wh=pre_wh + dec_wh,
            input_tokens=n_in,
            output_tokens=out_tokens, ttft_ms=latency_ms,
            prefix_reused=req.prefix_reused, prefill_wh=pre_wh)
        resp.accuracy = acc  # type: ignore[attr-defined]
        return resp

    def step(self) -> List[Response]:
        if self._failed:
            raise EngineFailure(f"engine {self.name} failed")
        self._last_step_s = self.clock()
        out: List[Response] = []
        if not self.queue:
            return out
        keep: List[Request] = []
        active = 0
        tick_dt = 0.0
        for pos, req in enumerate(self.queue):
            if active >= self.concurrency:
                keep.extend(self.queue[pos:])
                break
            if req.defunct:
                self._progress.pop(req.uid, None)
                self._outcomes.pop(req.uid, None)
                continue                       # drop; frees its slot
            active += 1
            outcome = self._activate(req)
            # the tick takes as long as its slowest active request's
            # per-step share (slots run concurrently, like real slots)
            tick_dt = max(tick_dt,
                          outcome[2] / 1e3 / max(self.steps_per_query, 1))
            k = self._progress.get(req.uid, 0) + 1
            if k < self.steps_per_query:
                self._progress[req.uid] = k
                keep.append(req)
                continue
            self._progress.pop(req.uid, None)
            self._outcomes.pop(req.uid, None)
            out.append(self._finish(req, outcome))
        self.queue = keep
        self._modeled_time_s += tick_dt
        return out

    def restart(self) -> List[Request]:
        # like ModelEngine.restart: defunct requests are dropped, never
        # resurrected into the scheduler's bookkeeping
        inflight = [r for r in self.queue if not r.defunct]
        for r in inflight:
            r.state = RequestState.QUEUED
            r.start_s = 0.0
            r.prefix_reused = 0          # re-probes on re-admission
        self.queue = []
        self._progress.clear()
        self._outcomes.clear()
        self._failed = False
        return inflight
