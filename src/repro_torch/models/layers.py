"""Primitive layers: norms, RoPE, SwiGLU MLP, embed/unembed, and the
parameter init rule.

Parameters keep the JAX package's layouts at every einsum boundary
(``wi_gate`` is (d_model, d_ff), ``wq`` is (d_model, heads, head_dim), …)
so both packages compute the same contractions, and a JAX parameter tree
converts without transposes (``models/convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def param(shape: Sequence[int], dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    """An uninitialized parameter, made without autograd: serving never
    records a graph, and the train step turns it on for its own model's
    parameters while it runs (``train/step.py``)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


def init_std(name: str, shape: Sequence[int]) -> Optional[float]:
    """The std of the JAX package's normal draw for a leaf called ``name``
    of ``shape`` — the leaf as the JAX tree holds it, per-layer leaves
    stacked on their layer axis — or None for a leaf that takes no normal
    draw (norms, biases, ``a_log``, ``decay*``).  Embeddings take 0.02,
    every other leaf 1/sqrt(fan_in) with fan_in = shape[-2] (the last dim
    for 1-d leaves): a layer's (d,) vector is (L, d) once stacked, so it
    draws N(0, 1/L)."""
    if name.startswith(("norm", "scale", "ln", "bias", "dt_bias", "a_log",
                        "decay")):
        return None
    if name.startswith("embed"):
        return 0.02
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    return 1.0 / math.sqrt(fan_in)


def init_leaf_(name: str, p: torch.Tensor, generator: torch.Generator,
               leaf_shape: Optional[Sequence[int]] = None) -> None:
    """The JAX package's init rule for one leaf, in place: norms 1, biases
    0, Mamba's ``a_log`` log U[1, 16), RWKV's ``decay*`` U[-8, -4),
    everything else N(0, ``init_std(name, leaf_shape)``).  ``leaf_shape``
    is the shape of the JAX leaf ``p`` belongs to (default: ``p``'s own,
    as for a stacked tree).  Draws are float32 from ``generator``, then
    cast to the parameter's dtype."""
    if name.startswith(("norm", "scale", "ln")):
        p.fill_(1.0)
        return
    if name.startswith(("bias", "dt_bias")):
        p.zero_()
        return
    if name.startswith(("a_log", "decay")):
        lo, hi = (1.0, 16.0) if name.startswith("a_log") else (-8.0, -4.0)
        draw = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                          device=p.device) * (hi - lo) + lo
        p.copy_(torch.log(draw) if name.startswith("a_log") else draw)
        return
    std = init_std(name, p.shape if leaf_shape is None else leaf_shape)
    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                       device=p.device)
    p.copy_(draw * std)


def leaf_shapes(module: nn.Module) -> list:
    """(JAX leaf name, the JAX leaf's shape) for every parameter of a
    whole model, in ``named_parameters`` order: a per-layer parameter's
    leaf is stacked on a leading axis of its layer count
    (``convert.leaf_groups``)."""
    from repro_torch.models import convert   # convert imports the models
    params = convert.jax_paths(module)
    out = [None] * len(params)
    for path, stacked, members in convert.leaf_groups(module):
        for j in members:
            shape = tuple(params[j][2].shape)
            out[j] = (path[-1], (len(members),) + shape if stacked else shape)
    return out


def init_module_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every parameter of a whole model in registration order,
    each by the JAX rule for the leaf it belongs to (``leaf_shapes``)."""
    with torch.no_grad():
        for p, (name, shape) in zip(module.parameters(),
                                    leaf_shapes(module)):
            init_leaf_(name, p, generator, shape)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.wi_gate = param((d_model, d_ff), dtype, device)
        self.wi_up = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)


def mlp(params: MLP, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, params.wi_gate.to(compute_dtype))
    u = torch.einsum("...d,df->...f", x, params.wi_up.to(compute_dtype))
    h = nn.functional.silu(g) * u
    return torch.einsum("...f,fd->...d", h, params.wo.to(compute_dtype))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table.to(compute_dtype)[tokens.long()]


def unembed(table: torch.Tensor, unembed_w, x: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """``unembed_w`` (d, V), or None for tied embeddings (``table``ᵀ)."""
    w = (unembed_w.to(compute_dtype) if unembed_w is not None
         else table.to(compute_dtype).T)
    return torch.einsum("...d,dv->...v", x, w)
