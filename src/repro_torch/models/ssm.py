"""Mamba2 (SSD) block — selective state-space scan.

Prefill runs the SSD scan through the hand-written kernel's wrapper
(``kernels/mamba2``) under ``cfg.use_pallas`` and through the JAX
package's chunked form (intra-chunk quadratic form + inter-chunk state
recurrence) otherwise; decode is the exact single-step recurrence.
Scalar A per head, one group (B and C shared across heads).

Parameter names and layouts are the JAX tree's (``layers/mamba/...``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import param

MAMBA_HEAD_DIM = 64


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // MAMBA_HEAD_DIM, cfg.ssm_state


class Mamba(nn.Module):
    """in_proj → [z (d_inner), x (d_inner), B (n), C (n), dt (h)]; the
    depthwise causal conv over [x, B, C]; per-head A (as ``a_log``), the
    skip D and the dt bias, fp32 whatever ``cfg.param_dtype`` is."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        d = cfg.d_model
        d_inner, h, n = mamba_dims(cfg)
        conv_dim = d_inner + 2 * n
        self.in_proj = param((d, 2 * d_inner + 2 * n + h), dt, device)
        self.conv_w = param((cfg.ssm_conv, conv_dim), dt, device)
        self.conv_bias = param((conv_dim,), dt, device)
        self.a_log = param((h,), torch.float32, device)
        self.d_skip = param((h,), torch.float32, device)
        self.dt_bias = param((h,), torch.float32, device)
        self.norm_gate = param((d_inner,), dt, device)
        self.out_proj = param((d_inner, d), dt, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, C); w: (K, C) depthwise causal conv.  Returns (SiLU(conv
    + bias), the trailing K-1 inputs — the state decode carries)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return nn.functional.silu(y + bias[None, None]), new_state


def _split_proj(p: Mamba, u: torch.Tensor, cfg: ModelConfig):
    d_inner, _, n = mamba_dims(cfg)
    proj = torch.einsum("bsd,de->bse", u, p.in_proj.to(cfg.torch_dtype()))
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * n,
                                        proj.shape[-1] - 2 * d_inner - 2 * n],
                                 dim=-1)
    return z, xbc, dt_raw


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's chunked SSD scan (the plain path).

    x: (b, s, h, p); dt: (b, s, h); B, C: (b, s, n); A: (h,).  Chunks of
    ``chunk`` tokens (one chunk of S when that does not divide S).
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    if s % L:
        L = s
    A = A.float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s, L):
        xb, dtb, Bb, Cb = (a[:, c0:c0 + L].float() for a in (x, dt, B, C))
        cum = torch.cumsum(dtb * A[None, None], dim=1)    # (b, L, h)
        # intra-chunk: M[b,t,s,h] = C_t·B_s · exp(cum_t − cum_s) · dt_s, s ≤ t
        G = torch.einsum("btn,bsn->bts", Cb, Bb)
        diff = cum[:, :, None, :] - cum[:, None, :, :]    # (b, t, s, h)
        m4 = mask[None, :, :, None]
        M = torch.where(m4, torch.exp(torch.where(m4, diff, 0.0)), 0.0)
        M = M * G[..., None] * dtb[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", M, xb)
        # inter-chunk: (C_t · h_in) · exp(cum_t); the first chunk of a
        # zero initial state carries nothing in
        y_inter = (torch.einsum("btn,bhpn->bthp", Cb, state)
                   * torch.exp(cum)[..., None]
                   if c0 or h0 is not None else 0.0)
        scale = torch.exp(cum[:, -1:, :] - cum) * dtb     # (b, L, h)
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("blh,blhp,bln->bhpn", scale, xb, Bb))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).to(x.dtype), state


def mamba_prefill(p: Mamba, u: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256):
    """u: (B, S, d) normed → (y (B, S, d), (conv_state, ssm_state))."""
    d_inner, h, n = mamba_dims(cfg)
    dt_ = cfg.torch_dtype()
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w.to(dt_), p.conv_bias.to(dt_))
    xin, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = nn.functional.softplus(dt_raw.float() + p.dt_bias[None, None])
    A = -torch.exp(p.a_log)
    xh = xin.reshape(*xin.shape[:2], h, MAMBA_HEAD_DIM)
    if cfg.use_pallas:
        y, ssm_state = ssd_ops.ssd(xh, dt, B, C, A)
    else:
        y, ssm_state = ssd_chunked(xh, dt, B, C, A, chunk)
    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(*u.shape[:2], d_inner).to(dt_)
    y = y * nn.functional.silu(z)                        # gated
    y = y * p.norm_gate.to(dt_)[None, None]
    return torch.einsum("bse,ed->bsd", y, p.out_proj.to(dt_)), (
        conv_state, ssm_state)


def mamba_decode(p: Mamba, u: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, cfg: ModelConfig):
    """Single-token recurrence.  u: (B, 1, d) normed; states from the
    cache.  Returns (y (B, 1, d), (conv_state, ssm_state)), new tensors."""
    d_inner, h, n = mamba_dims(cfg)
    dt_ = cfg.torch_dtype()
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w.to(dt_), p.conv_bias.to(dt_),
                                   state=conv_state)
    xin, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = nn.functional.softplus(dt_raw.float() + p.dt_bias[None, None])
    A = -torch.exp(p.a_log)
    xh = xin.reshape(xin.shape[0], h, MAMBA_HEAD_DIM).float()
    # h' = h·exp(dt·A) + dt·x⊗B ;  y = C·h' + D·x
    decay = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[:, 0, :, None],
                       B[:, 0].float())
    ssm_state = ssm_state * decay + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), ssm_state)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(u.shape[0], 1, d_inner).to(dt_)
    y = y * nn.functional.silu(z) * p.norm_gate.to(dt_)[None, None]
    return torch.einsum("bse,ed->bsd", y, p.out_proj.to(dt_)), (
        conv_state, ssm_state)


class MambaBlock(nn.Module):
    """One Mamba2 layer of the hybrid: ``norm`` then the ``mamba``
    parameters (``layers/{norm,mamba}`` in the JAX tree)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.norm = param((cfg.d_model,), cfg.torch_param_dtype(), device)
        self.mamba = Mamba(cfg, device)
