"""Serving request/response types and per-request lifecycle state."""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional

from repro_torch.core.types import Query


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"      # prompt tokens streaming into the cache
    MIGRATING = "migrating"  # prompt KV in transit prefill→decode engine
    DECODE = "decode"        # generating
    DONE = "done"
    FAILED = "failed"        # attempts exhausted (terminal, no response)
    CANCELLED = "cancelled"  # hedged duplicate that lost the race
    TIMED_OUT = "timed_out"  # deadline passed before completion (terminal)


@dataclasses.dataclass
class Request:
    """One routed query's engine-side lifecycle state.

    Token counts are in tokenizer tokens; every ``*_s`` field is a
    ``time.monotonic()`` timestamp in seconds (0.0 = not reached yet):
    ``submit_s`` at routing, ``start_s`` at slot admission (queue wait
    ends), ``first_token_s`` at the first *generated* token (TTFT), and
    ``finish_s`` at completion.  ``n_prompt_fed`` is the prompt cursor —
    how many prompt tokens the engine has consumed into the cache
    (advanced by 1 on the token-wise path, by up to ``prefill_chunk`` per
    chunked-prefill tick)."""

    query: Query
    prompt_tokens: List[int]
    max_new_tokens: int
    eos_id: int = 0
    # lifecycle
    state: RequestState = RequestState.QUEUED
    model_name: str = ""
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    n_prompt_fed: int = 0
    prefix_reused: int = 0   # prompt tokens spliced from the prefix-KV cache
    # --- prefill→decode disaggregation (docs/SERVING.md) ---
    # (k, v) numpy blocks captured on the prefill engine at phase boundary,
    # carried by the scheduler to the decode twin, cleared after splice
    kv_payload: Optional[tuple] = None
    kv_migrated: int = 0     # prompt-KV tokens moved between engines
    prefill_wh: float = 0.0  # metered prefill-phase Wh, stamped at migration
    # (task_label, cluster, embedding) computed once by the scheduler's
    # cache probe; reused at completion for the semantic insert
    cache_features: Optional[tuple] = None
    # pre-dispatch Wh forecast stamped at admission by the scheduler's
    # EnergyCostModel (0.0 = no cost model / never predicted); reconciled
    # against the metered energy_wh at completion
    predicted_wh: float = 0.0
    submit_s: float = dataclasses.field(default_factory=time.monotonic)
    start_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    hedged: bool = False
    hedge_of: Optional[int] = None   # uid of the primary request
    # --- reliability (docs/RELIABILITY.md) ---
    # end-to-end deadline in seconds from ``submit_s`` (0.0 = none); the
    # deadline covers *all* attempts — retries never reset the clock
    deadline_s: float = 0.0
    attempts: int = 0        # failed attempts so far (0 = first try clean)
    max_retries: int = 0     # re-dispatches allowed after the first attempt

    @property
    def uid(self) -> int:
        return self.query.uid

    @property
    def prefill_done(self) -> bool:
        return self.n_prompt_fed >= len(self.prompt_tokens)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.FAILED,
                              RequestState.CANCELLED, RequestState.TIMED_OUT)

    @property
    def defunct(self) -> bool:
        """Terminal without a completion — engines must drop the request
        on sight (free its slot, never decode it, never resurrect it on
        restart).  DONE is deliberately excluded: a finished request has a
        Response and exits through the normal completion path."""
        return self.state in (RequestState.CANCELLED, RequestState.FAILED,
                              RequestState.TIMED_OUT)

    @property
    def latency_ms(self) -> float:
        """End-to-end milliseconds (submit → finish); 0.0 while unfinished."""
        if self.finish_s and self.submit_s:
            return (self.finish_s - self.submit_s) * 1e3
        return 0.0


@dataclasses.dataclass
class Response:
    """The completed-request record the scheduler hands back: latencies in
    milliseconds (``latency_ms`` end-to-end, ``queue_ms`` submission →
    admission, ``ttft_ms`` submission → first generated token), energy in
    watt-hours (``energy_wh``, both phases), token counts in tokenizer
    tokens."""

    uid: int
    model_name: str
    tokens: List[int]
    text: str
    latency_ms: float
    queue_ms: float
    energy_wh: float
    input_tokens: int
    output_tokens: int
    hedged_winner: bool = False
    ttft_ms: float = 0.0     # time to first generated token (0 = unknown)
    prefix_reused: int = 0   # prompt tokens served from the prefix-KV cache
    kv_migrated: int = 0     # prompt-KV tokens moved prefill→decode engine
    # prefill-phase share of energy_wh (migration DMA included); 0.0 for
    # engines without a phase split.  The cost model trains its per-phase
    # residual buckets from this split.
    prefill_wh: float = 0.0
