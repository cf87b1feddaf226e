"""Chunked-prefill benchmark: TTFT in engine steps against
``prefill_chunk``.

Drives one smoke-config ``ModelEngine`` with a long prompt at several
chunk sizes and reports steps to the first token with the per-phase
modeled joules — the measured face of "TTFT drops by the chunk factor".
Wall seconds are printed for context; the step count is the deterministic
quantity.

    PYTHONPATH=src python -m repro_torch.benchmarks.prefill \
        [--arch granite-3-8b] [--prompt-len 96] [--device cpu]

runs the engine on the card (``--device cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Sequence

from repro_torch.configs import get_config
from repro_torch.core.types import Query
from repro_torch.data import tokenizer as tok
from repro_torch.serving import ModelEngine, Request


def steps_to_first_token(arch: str, prompt_len: int, chunk: int,
                         device=None, params=None):
    """(steps until the prompt's first token, wall seconds, joules by
    phase) for one request on a fresh two-slot engine."""
    cfg = get_config(arch, smoke=True, vocab_size=tok.VOCAB_SIZE)
    eng = ModelEngine(arch, cfg, 0, max_batch=2,
                      max_len=max(2 * prompt_len, 64), prefill_chunk=chunk,
                      params=params, device=device)
    req = Request(query=Query(uid=0, text="bench"),
                  prompt_tokens=[1 + (i % 250) for i in range(prompt_len)],
                  max_new_tokens=4)
    eng.submit(req)
    steps = 0
    t0 = time.perf_counter()
    while not req.generated and steps < 10 * prompt_len:
        eng.step()
        steps += 1
    wall_s = time.perf_counter() - t0
    return steps, wall_s, eng.cumulative_joules_by_phase()


def main(arch: str = "granite-3-8b", prompt_len: int = 96,
         chunks: Sequence[int] = (1, 4, 8, 16), device=None,
         params=None) -> List[str]:
    lines = [f"# {arch}, prompt_len={prompt_len} "
             f"(steps-to-first-token; chunk=1 is the token-wise path)",
             "chunk,ttft_steps,speedup,wall_s,prefill_j,decode_j"]
    base_steps = None
    for chunk in chunks:
        steps, wall_s, phases = steps_to_first_token(arch, prompt_len, chunk,
                                                     device, params)
        if base_steps is None:
            base_steps = steps
        lines.append(f"{chunk},{steps},{base_steps / steps:.1f}x,"
                     f"{wall_s:.2f},{phases['prefill']:.3e},"
                     f"{phases['decode']:.3e}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(args.arch, args.prompt_len, args.chunks,
                         device=args.device)))
