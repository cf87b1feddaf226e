"""RWKV6 ("Finch") block — data-dependent decay linear attention.

Time-mix with per-channel data-dependent decay w_t = exp(-exp(base +
lora(x))) and bonus u for the current token; the WKV scan runs through
the hand-written kernel's wrapper (``kernels/rwkv6``) under
``cfg.use_pallas`` and through the chunked fp32 form (chunk 128) of the
JAX package otherwise; decode is the exact O(1)-state step.  Channel-mix
is the squared-ReLU RWKV FFN.

State per layer: (shift_tm (B, d), shift_cm (B, d), wkv (B, H, K, V)).
Parameter names and layouts are the JAX tree's (``layers/rwkv/...``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import param

RWKV_HEAD_DIM = 64
LORA_RANK = 32


class RwkvLayerState(NamedTuple):
    shift_tm: torch.Tensor   # (B, d) last token seen by time-mix
    shift_cm: torch.Tensor   # (B, d) last token seen by channel-mix
    wkv: torch.Tensor        # (B, H, K, V) linear-attention state


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.d_model // RWKV_HEAD_DIM, RWKV_HEAD_DIM


class RWKV(nn.Module):
    """The time-mix and channel-mix parameters of one layer; the decay
    base and the bonus are fp32 whatever ``cfg.param_dtype`` is, as in the
    JAX tree."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        d, f = cfg.d_model, cfg.d_ff
        shapes = {
            "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_w": (d,),
            "mu_g": (d,),
            "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
            "wo_tm": (d, d),
            "decay_base": (d,),
            "lora_a_decay": (d, LORA_RANK), "lora_b_decay": (LORA_RANK, d),
            "bonus_u": (d,),
            "ln_x": (d,),
            "mu_ck": (d,), "mu_cr": (d,),
            "ck": (d, f), "cv": (f, d), "cr": (d, d),
        }
        for name, shape in shapes.items():
            dtype = (torch.float32 if name in ("decay_base", "bonus_u")
                     else dt)
            setattr(self, name, param(shape, dtype, device))


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Previous-token stream: [last, x_0, ..., x_{S-2}]."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xx: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xx - x) * mu[None, None]


def _decay(p: RWKV, xw: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    lora = torch.tanh(xw @ p.lora_a_decay.to(dt)) @ p.lora_b_decay.to(dt)
    return -torch.exp(p.decay_base[None, None] + lora.float())  # (B, S, d)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, chunk: int = 128,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's chunked WKV (the plain path): r, k, v, logw (B,
    S, H, K), u (H, K) → (y in r's dtype, final state (B, H, K, K) fp32).
    Chunks of ``chunk`` tokens (one chunk of S when that does not divide
    S); inside a chunk the exp(±cumsum log w) factorization in fp32."""
    b, s, h, kd = r.shape
    L = min(chunk, s)
    if s % L:
        L = s
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)                       # strictly lower
    state = (torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    ys = []
    for c0 in range(0, s, L):
        rb, kb, vb, wb = (a[:, c0:c0 + L].float() for a in (r, k, v, logw))
        cum = torch.cumsum(wb, dim=1)                   # inclusive Σ log w
        cum_prev = cum - wb
        r_dec = rb * torch.exp(cum_prev)
        # the first chunk of a zero initial state carries nothing in
        y_inter = (torch.einsum("blhk,bhkv->blhv", r_dec, state)
                   if c0 or s0 is not None else 0.0)
        b_ = kb * torch.exp(-cum)
        att = torch.einsum("bthk,bshk->bhts", r_dec, b_)
        att = torch.where(tri[None, None], att, 0.0)
        y_intra = torch.einsum("bhts,bshv->bthv", att, vb)
        y_diag = (rb * u[None, None] * kb).sum(-1, keepdim=True) * vb
        k_dec = kb * torch.exp(cum[:, -1:] - cum)
        state = (state * torch.exp(cum[:, -1])[..., None]
                 + torch.einsum("bshk,bshv->bhkv", k_dec, vb))
        ys.append(y_inter + y_intra + y_diag)
    return torch.cat(ys, dim=1).to(r.dtype), state


def wkv_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s_in: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single step.  r, k, v, logw: (B, 1, H, K); s_in: (B, H, K, V)."""
    rf, kf, vf = (a[:, 0].float() for a in (r, k, v))
    w = torch.exp(logw[:, 0].float())
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, s_in + u[None, :, :, None] * kv)
    return y[:, None].to(r.dtype), s_in * w[..., None] + kv


def _tm_project(p: RWKV, x: torch.Tensor, shift: torch.Tensor,
                cfg: ModelConfig):
    h, kd = rwkv_dims(cfg)
    dt = cfg.torch_dtype()
    xx = (_token_shift(x, shift) if x.shape[1] > 1
          else shift[:, None].to(x.dtype))
    r = _mix(x, xx, p.mu_r.to(dt)) @ p.wr.to(dt)
    k = _mix(x, xx, p.mu_k.to(dt)) @ p.wk.to(dt)
    v = _mix(x, xx, p.mu_v.to(dt)) @ p.wv.to(dt)
    g = _mix(x, xx, p.mu_g.to(dt)) @ p.wg.to(dt)
    logw = _decay(p, _mix(x, xx, p.mu_w.to(dt)), dt)
    b, s, _ = x.shape
    split = lambda a: a.reshape(b, s, h, kd)
    u = p.bonus_u.reshape(h, kd)
    return split(r), split(k), split(v), split(logw), g, u


def rwkv_time_mix(p: RWKV, x: torch.Tensor, state: RwkvLayerState,
                  cfg: ModelConfig, decode: bool = False
                  ) -> Tuple[torch.Tensor, RwkvLayerState]:
    """x: (B, S, d) normed → (out (B, S, d), the state after the last
    token).  ``decode`` takes the one-step recurrence (S == 1)."""
    b, s, d = x.shape
    dt = cfg.torch_dtype()
    r, k, v, logw, g, u = _tm_project(p, x, state.shift_tm, cfg)
    if decode:
        y, wkv = wkv_decode(r, k, v, logw, u, state.wkv)
    elif cfg.use_pallas:
        y, wkv = wkv_ops.wkv(r, k, v, logw, u, s0=state.wkv)
    else:
        y, wkv = wkv_chunked(r, k, v, logw, u, s0=state.wkv)
    # per-head group norm (ln_x) then the gate
    y32 = y.reshape(b, s, -1, RWKV_HEAD_DIM).float()
    mean = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, unbiased=False)
    y = ((y32 - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, d).to(dt)
    y = y * p.ln_x.to(dt)[None, None]
    y = y * nn.functional.silu(g)
    out = y @ p.wo_tm.to(dt)
    return out, state._replace(
        shift_tm=x[:, -1].to(state.shift_tm.dtype), wkv=wkv)


def rwkv_channel_mix(p: RWKV, x: torch.Tensor, state: RwkvLayerState,
                     cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, RwkvLayerState]:
    dt = cfg.torch_dtype()
    xx = (_token_shift(x, state.shift_cm) if x.shape[1] > 1
          else state.shift_cm[:, None].to(x.dtype))
    k = _mix(x, xx, p.mu_ck.to(dt)) @ p.ck.to(dt)
    kv = torch.square(torch.relu(k)) @ p.cv.to(dt)
    r = torch.sigmoid(_mix(x, xx, p.mu_cr.to(dt)) @ p.cr.to(dt))
    return r * kv, state._replace(
        shift_cm=x[:, -1].to(state.shift_cm.dtype))


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    device: torch.device) -> RwkvLayerState:
    h, kd = rwkv_dims(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return RwkvLayerState(shift_tm=zeros(batch, cfg.d_model),
                          shift_cm=zeros(batch, cfg.d_model),
                          wkv=zeros(batch, h, kd, kd))


class RWKVBlock(nn.Module):
    """One RWKV layer: ``ln1`` before time-mix, ``ln2`` before
    channel-mix, and the ``rwkv`` parameters (``layers/{ln1,ln2,rwkv}``
    in the JAX tree)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.ln1 = param((cfg.d_model,), dt, device)
        self.ln2 = param((cfg.d_model,), dt, device)
        self.rwkv = RWKV(cfg, device)
