"""Mixture-of-Experts: sort-based capacity-bounded dispatch + shared experts.

As in the JAX package: tokens are sorted by assigned expert and bucketed
into an (E, C, d) tensor (C = the expert capacity; overflow tokens are
dropped), the experts run as one batched product, and the results are
scattered back with their gate weights.  Dispatch groups are those of the
reference: one group per batch row when S > 1 (prefill, chunk ticks), one
group of all B tokens when S == 1 (decode).  Gating is row-wise, so one
router product and one gating call cover every group of a layer; the
capacity sort and the scatter stay per group, batched over a leading
group axis with static shapes (no boolean indexing, no host sync).

With ``use_pallas`` the top-k gate runs through ``kernels/moe_gating``
(the CUDA kernel for CUDA tensors); otherwise through ``top_k_gating``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels.moe_gating import ops as gate_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, mlp, param


class MoE(nn.Module):
    """router (d, E), wi_gate/wi_up (E, d, f), wo (E, f, d), and the shared
    experts as one SwiGLU MLP of width f · n_shared_experts — the JAX
    layouts (``moe.moe_shapes``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = param((d, e), dt, device)
        self.wi_gate = param((e, d, f), dt, device)
        self.wi_up = param((e, d, f), dt, device)
        self.wo = param((e, f, d), dt, device)
        self.shared = (MLP(d, f * cfg.n_shared_experts, dt, device)
                       if cfg.n_shared_experts else None)


def top_k_gating(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k) softmaxed over the chosen k, indices (T, k) int32),
    descending by logit with ties to the lowest index, as ``lax.top_k``:
    a stable descending sort keeps equal logits in index order."""
    gates, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return (torch.softmax(gates[:, :k], dim=-1),
            idx[:, :k].to(torch.int32))


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(((c + 7) // 8) * 8, 8)  # padded to 8, as in the reference


def _dispatch(params: MoE, xg: torch.Tensor, cfg: ModelConfig,
              use_pallas: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """G dispatch groups at once.  xg: (G, t, d) → (out (G, t, d), aux
    loss per group (G,))."""
    g, t, d = xg.shape
    dt = cfg.torch_dtype()
    e, k = cfg.n_experts, cfg.top_k
    dev = xg.device

    logits = torch.einsum("gtd,de->gte", xg,
                          params.router.to(dt)).float()        # (G, t, E)
    gate = gate_ops.topk_gating if use_pallas else top_k_gating
    weights, idx = gate(logits.reshape(g * t, e), k)
    weights = weights.reshape(g, t * k)
    flat_expert = idx.reshape(g, t * k).long()

    # load-balancing auxiliary loss (Switch-style): E * Σ_e f_e · p_e
    me = torch.softmax(logits, dim=-1).mean(dim=1)              # (G, E)
    ce = nn.functional.one_hot(flat_expert.reshape(g, t, k)[..., 0],
                               e).float().mean(dim=1)
    aux = e * (me * ce).sum(dim=-1)

    c = expert_capacity(t, e, k, cfg.capacity_factor)

    # --- sort-based dispatch ---------------------------------------------
    # The argsort is STABLE, as jnp.argsort: within an expert, earlier
    # slab positions rank first, so chunk padding (always a row's suffix)
    # never evicts a real token from capacity.
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)  # (t*k,)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = flat_token[order]                             # (G, t*k)
    sorted_weight = torch.gather(weights, 1, order)
    expert_start = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = (torch.arange(t * k, device=dev)
            - torch.gather(expert_start, 1, sorted_expert))
    keep = rank < c
    slot = torch.where(keep, sorted_expert * c + rank,
                       torch.full_like(rank, e * c))  # overflow → scratch row

    gathered = torch.gather(xg, 1, sorted_token[..., None].expand(-1, -1, d))
    buckets = torch.zeros((g, e * c + 1, d), dtype=dt, device=dev)
    buckets.scatter_(1, slot[..., None].expand(-1, -1, d),
                     torch.where(keep[..., None], gathered,
                                 torch.zeros((), dtype=dt, device=dev)))
    # (G, E·C, d) → (E, G·C, d): every group's bucket of expert e together
    buckets = (buckets[:, :-1].reshape(g, e, c, d).transpose(0, 1)
               .reshape(e, g * c, d))

    # --- batched expert FFN (plain products, as the reference leaves them
    # to XLA outside any kernel) --------------------------------------------
    h = (nn.functional.silu(torch.bmm(buckets, params.wi_gate.to(dt)))
         * torch.bmm(buckets, params.wi_up.to(dt)))
    expert_out = torch.bmm(h, params.wo.to(dt))                 # (E, G·C, d)
    flat_out = (expert_out.reshape(e, g, c, d).transpose(0, 1)
                .reshape(g, e * c, d))

    # --- combine: scatter back with the gate weights ----------------------
    contrib = torch.gather(
        flat_out, 1, slot.clamp(max=e * c - 1)[..., None].expand(-1, -1, d)
    ) * (sorted_weight * keep).to(dt)[..., None]
    rows = (sorted_token + torch.arange(g, device=dev)[:, None] * t)
    out = torch.zeros((g * t, d), dtype=dt, device=dev)
    out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, d))
    return out.reshape(g, t, d), aux


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelConfig,
              use_pallas: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux loss scalar).  Per-row dispatch
    groups for S > 1 (aux averaged over rows), one group for S == 1."""
    b, s, d = x.shape
    if s > 1:
        out, aux = _dispatch(params, x, cfg, use_pallas)
        aux = aux.mean()
    else:
        out, aux = _dispatch(params, x.reshape(1, b, d), cfg, use_pallas)
        out, aux = out.reshape(b, s, d), aux[0]
    if params.shared is not None:
        out = out + mlp(params.shared, x, cfg.torch_dtype())
    return out, aux
