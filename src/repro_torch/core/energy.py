"""Analytic H100 energy model + roofline terms.

The paper measures GPU energy with zeus/NVML.  The serving engines charge
every query from first principles instead, so the bandit sees the same
energy signal on any host:

    t_step  = max(t_compute, t_memory, t_collective)          (roofline)
    E_step  = P_static · t_step
            + e_flop · FLOPs + e_hbm · HBM_bytes + e_link · link_bytes

The FLOPs/bytes terms come from the analytic per-token transformer cost
model below.  The formulas are the JAX package's; the constants are the
published figures of one NVIDIA H100 SXM (dense bf16 rate, HBM3 rate,
board power, NVLink bandwidth each way).  The static share of board power
is a named assumption (``CHIP_IDLE_W``), not a measurement.  The
interface is pluggable so a measured-power backend can replace this.
"""
from __future__ import annotations

import dataclasses

# --- NVIDIA H100 SXM constants (per card, data-sheet figures) ---------------
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
LINK_BW = 450e9                 # bytes/s, NVLink to the other cards, each way
CHIP_TDP_W = 700.0              # board power limit
# ASSUMPTION: static / leakage share of board power — the same 30% share
# the JAX package assumed for its chip; not measured on an H100
CHIP_IDLE_W = 0.3 * CHIP_TDP_W

# dynamic energy coefficients (derived so that a card at 100% utilization of
# one resource dissipates (TDP - idle) through that resource)
E_PER_FLOP = (CHIP_TDP_W - CHIP_IDLE_W) / PEAK_FLOPS_BF16     # J / FLOP
E_PER_HBM_BYTE = (CHIP_TDP_W - CHIP_IDLE_W) / HBM_BW          # J / byte
E_PER_LINK_BYTE = (CHIP_TDP_W - CHIP_IDLE_W) / LINK_BW        # J / byte

JOULES_PER_WH = 3600.0


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds, for one step on `chips` cards."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    hbm_bytes: float
    link_bytes: float
    chips: int

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of ideal (compute-bound) time: 1.0 = at compute roofline."""
        if self.t_step <= 0:
            return 0.0
        return self.t_compute / self.t_step


def roofline(flops: float, hbm_bytes: float, link_bytes: float,
             chips: int = 1) -> RooflineTerms:
    """FLOPs/bytes are *totals*, divided across ``chips`` cards."""
    return RooflineTerms(
        t_compute=flops / (chips * PEAK_FLOPS_BF16),
        t_memory=hbm_bytes / (chips * HBM_BW),
        t_collective=link_bytes / (chips * LINK_BW),
        flops=flops, hbm_bytes=hbm_bytes, link_bytes=link_bytes, chips=chips)


def energy_joules(terms: RooflineTerms) -> float:
    """Analytic per-step energy across all chips involved."""
    dynamic = (E_PER_FLOP * terms.flops + E_PER_HBM_BYTE * terms.hbm_bytes +
               E_PER_LINK_BYTE * terms.link_bytes)
    static = CHIP_IDLE_W * terms.t_step * terms.chips
    return dynamic + static


def energy_wh(terms: RooflineTerms) -> float:
    return energy_joules(terms) / JOULES_PER_WH


# ---------------------------------------------------------------------------
# Analytic transformer cost model (per-query serving energy).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostModelParams:
    """Minimal shape info needed for the 6ND-style cost model."""

    n_params: float                  # total parameters
    n_active_params: float           # active per token (MoE: routed subset)
    d_model: int
    n_layers: int
    kv_heads: int
    head_dim: int
    dtype_bytes: int = 2


def decode_step_cost(p: CostModelParams, kv_len: int, batch: int = 1):
    """(flops, hbm_bytes) for one decode token per sequence.

    FLOPs ≈ 2·N_active per token (matmul) + attention 2·2·kv·d_kv reads.
    HBM ≈ full weight read (decode is weight-bandwidth-bound) + KV read.
    """
    flops = 2.0 * p.n_active_params * batch
    kv_dim = p.kv_heads * p.head_dim
    flops += 4.0 * kv_len * kv_dim * p.n_layers * batch
    weight_bytes = p.n_active_params * p.dtype_bytes
    kv_bytes = 2.0 * kv_len * kv_dim * p.n_layers * p.dtype_bytes * batch
    return flops, weight_bytes + kv_bytes


def prefill_chunk_cost(p: CostModelParams, n_tokens: int, kv_len: int,
                       batch: int = 1):
    """(flops, hbm_bytes) for one *chunked-prefill step*: ``n_tokens``
    prompt tokens appended per sequence at cache offset ``kv_len`` — the
    prefill-phase counterpart of ``decode_step_cost``.

    FLOPs ≈ 2·N_active per token (matmuls, compute-bound — prefill
    amortizes the weight read over the chunk) + attention QK/AV against the
    growing cache (midpoint kv depth).  HBM ≈ one active-weight read for
    the whole chunk step (this is the chunking win: the one-token path
    pays that read per token) + KV read/write at the chunk's depth.
    Everything is per step; multiply by steps for a whole prompt.
    """
    n = max(n_tokens, 1)
    flops = 2.0 * p.n_active_params * n * batch
    kv_dim = p.kv_heads * p.head_dim
    mid_kv = kv_len + (n + 1) / 2.0
    flops += 4.0 * n * mid_kv * kv_dim * p.n_layers * batch
    weight_bytes = p.n_active_params * p.dtype_bytes
    kv_bytes = 2.0 * (kv_len + n) * kv_dim * p.n_layers * p.dtype_bytes * batch
    return flops, weight_bytes + kv_bytes


def chunk_rider_cost(p: CostModelParams, chunk: int, kv_len: int,
                     batch: int = 1):
    """(flops, hbm_bytes) for ONE decode token that *rides along* inside a
    ``chunk``-wide chunked-prefill step (a mixed tick on a unified
    engine).  The fused chunk kernel computes all ``chunk`` positions for
    every live slot — padding is real compute, not free — so the rider's
    matmul and attention FLOPs are chunk-padded while its HBM traffic
    stays decode-shaped (weight read + KV read at its depth).  This is
    the prefill/decode *interference* cost that role-specialized
    (disaggregated) engines avoid: on a decode-only engine the same token
    is charged plain ``decode_step_cost``.
    """
    C = max(chunk, 1)
    flops = 2.0 * p.n_active_params * C * batch
    kv_dim = p.kv_heads * p.head_dim
    flops += 4.0 * C * max(kv_len, 1) * kv_dim * p.n_layers * batch
    weight_bytes = p.n_active_params * p.dtype_bytes
    kv_bytes = 2.0 * max(kv_len, 1) * kv_dim * p.n_layers * p.dtype_bytes \
        * batch
    return flops, weight_bytes + kv_bytes


def kv_migration_cost(p: CostModelParams, n_tokens: int):
    """(flops, hbm_bytes) to move ``n_tokens`` of prompt KV between
    engines at the prefill→decode phase boundary: K and V, read out of
    the prefill engine's cache and written into the decode engine's slot
    (2 tensors × 2 directions).  Pure data movement — disaggregation pays
    this honestly, and still has to win on the metered ledger."""
    kv_dim = p.kv_heads * p.head_dim
    bytes_ = 4.0 * max(n_tokens, 0) * kv_dim * p.n_layers * p.dtype_bytes
    return 0.0, bytes_


def prefill_cost(p: CostModelParams, seq_len: int, batch: int = 1):
    """(flops, hbm_bytes) for a full prefill."""
    flops = 2.0 * p.n_active_params * seq_len * batch
    kv_dim = p.kv_heads * p.head_dim
    flops += 2.0 * seq_len * seq_len * kv_dim * p.n_layers * batch  # attn QK+AV
    act_bytes = 10.0 * seq_len * p.d_model * p.n_layers * p.dtype_bytes * batch
    weight_bytes = p.n_params * p.dtype_bytes
    return flops, weight_bytes + act_bytes


class EnergyMonitor:
    """Pluggable per-query energy accounting (zeus stand-in, DESIGN §4)."""

    def __init__(self, chips: int = 1):
        self.chips = chips
        self.total_joules = 0.0
        self.n_queries = 0

    def measure_query(self, p: CostModelParams, input_tokens: int,
                      output_tokens: int, batch: int = 1) -> float:
        """Returns modeled Wh for one query; accumulates totals."""
        f_pre, b_pre = prefill_cost(p, max(input_tokens, 1), batch)
        joules = energy_joules(roofline(f_pre, b_pre, 0.0, self.chips))
        kv = input_tokens
        # decode tokens at increasing kv length (use midpoint approximation)
        mid_kv = kv + max(output_tokens, 1) // 2
        f_dec, b_dec = decode_step_cost(p, mid_kv, batch)
        joules += max(output_tokens, 0) * energy_joules(
            roofline(f_dec, b_dec, 0.0, self.chips))
        self.total_joules += joules
        self.n_queries += 1
        return joules / JOULES_PER_WH

    @property
    def total_wh(self) -> float:
        return self.total_joules / JOULES_PER_WH
