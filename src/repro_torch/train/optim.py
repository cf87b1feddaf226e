"""AdamW + cosine schedule, with low-precision moments.

Moments are stored in ``cfg.moment_dtype`` (fp32 default; bf16 for
grok-314B) and promoted to fp32 inside the update.  Trees are the JAX
package's nested dicts of tensors, named and stacked as its parameter tree
(``models/convert.py``): decoupled weight decay applies to the leaves of
rank ≥ 2 *in that tree*, so a per-layer norm gain, (L, d) once stacked, is
decayed and the final norm, (d,), is not.

``adamw_update`` is the reference's function over trees.  The train step
updates its model's per-layer parameters in place against the layers'
slices of the stacked moments (``step.py``); both go through
``adamw_leaf_``, which takes a leaf's parts and its decay decision from
the caller.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Tuple

import torch

from repro_torch.models.convert import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"

    def torch_moment_dtype(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)


def divide(x: torch.Tensor, n: float) -> torch.Tensor:
    """x / n, a true division on every device: CUDA takes a Python number
    as divisor as a multiplication by its reciprocal."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(divide(step, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(divide(step - cfg.warmup_steps,
                              max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def opt_shapes(param_tree: Dict[str, Any], cfg: OptConfig) -> Dict[str, Any]:
    """The optimizer state's tree as meta tensors (the dry run's input)."""
    mom = lambda p: torch.empty(p.shape, dtype=cfg.torch_moment_dtype(),
                                device="meta")
    return {"m": tree_map(mom, param_tree), "v": tree_map(mom, param_tree),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def init_opt_state(params: Dict[str, Any], cfg: OptConfig,
                   device=None) -> Dict[str, Any]:
    """Zero moments shaped like ``params``' leaves, on ``device`` (each
    leaf's own device unless one is named), and step 0."""
    dt = cfg.torch_moment_dtype()
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,
                                  device=device or p.device)
    first = next(leaf for _, leaf in tree_items(params))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=device or first.device)}


def sum_squares(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ x² over every tensor, in fp32: each tensor's norm (one
    multi-tensor launch), squared and summed."""
    norms = torch._foreach_norm([x.float() for x in tensors])
    return torch.stack(norms).square().sum()


def global_norm(tree: Dict[str, Any]) -> torch.Tensor:
    return torch.sqrt(sum_squares(leaf for _, leaf in tree_items(tree)))


@dataclasses.dataclass(frozen=True)
class StepScalars:
    """What one AdamW step shares across leaves."""

    step: torch.Tensor          # int32, after this update
    lr: torch.Tensor
    grad_norm: torch.Tensor
    clip: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor


def step_scalars(opt_step: torch.Tensor, grad_norm: torch.Tensor,
                 cfg: OptConfig) -> StepScalars:
    step = opt_step + 1
    t = step.to(torch.float32)
    return StepScalars(
        step=step, lr=cosine_lr(cfg, step), grad_norm=grad_norm,
        clip=torch.clamp(cfg.grad_clip / torch.clamp(grad_norm, min=1e-12),
                         max=1.0),
        bc1=1.0 - cfg.b1 ** t, bc2=1.0 - cfg.b2 ** t)


@torch.no_grad()
def adamw_leaf_(ps: List[torch.Tensor], gs: List[torch.Tensor],
                ms: List[torch.Tensor], vs: List[torch.Tensor], decay: bool,
                s: StepScalars, cfg: OptConfig) -> None:
    """One leaf's AdamW step, in place on its parts (its layers' slices,
    or the whole leaf): p, m and v rewritten.  ``decay``: whether the leaf
    takes decoupled weight decay.  Each operation is the reference's, in
    its order and rounding (g·clip; b1·m + (1−b1)·g; b2·v + (1−b2)·g·g;
    (m/bc1) / (√(v/bc2) + eps) (+ wd·p); p − lr·delta), each one
    multi-tensor launch over the parts."""
    g32 = torch._foreach_mul([g.float() for g in gs], s.clip)
    m32 = torch._foreach_mul([m.float() for m in ms], cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - cfg.b1))
    sq = torch._foreach_mul(g32, 1 - cfg.b2)
    torch._foreach_mul_(sq, g32)
    del g32
    v32 = torch._foreach_mul([v.float() for v in vs], cfg.b2)
    torch._foreach_add_(v32, sq)
    del sq
    torch._foreach_copy_(ms, m32)
    torch._foreach_copy_(vs, v32)
    torch._foreach_div_(m32, s.bc1)
    torch._foreach_div_(v32, s.bc2)
    torch._foreach_sqrt_(v32)
    torch._foreach_add_(v32, cfg.eps)
    torch._foreach_div_(m32, v32)                   # delta
    del v32
    p32 = [p.float() for p in ps]
    if decay:                # decoupled weight decay on matrices only
        torch._foreach_add_(m32, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(m32, s.lr)
    torch._foreach_copy_(ps, torch._foreach_sub(p32, m32))


@torch.no_grad()
def adamw_update(grads: Dict[str, Any], opt_state: Dict[str, Any],
                 params: Dict[str, Any], cfg: OptConfig
                 ) -> Tuple[Dict[str, Any], Dict[str, Any],
                            Dict[str, torch.Tensor]]:
    """One AdamW step over trees; returns (params, opt_state, metrics) as
    new trees.  A leaf of rank ≥ 2 takes weight decay."""
    s = step_scalars(opt_state["step"], global_norm(grads), cfg)
    clone = lambda t: tree_map(torch.clone, t)  # noqa: E731
    new_p, new_m, new_v = (clone(params), clone(opt_state["m"]),
                           clone(opt_state["v"]))
    g_tree, m_tree, v_tree = (dict(tree_items(t))
                              for t in (grads, new_m, new_v))
    for path, p in tree_items(new_p):
        adamw_leaf_([p], [g_tree[path]], [m_tree[path]], [v_tree[path]],
                    p.dim() >= 2, s, cfg)
    metrics = {"lr": s.lr, "grad_norm": s.grad_norm}
    return new_p, {"m": new_m, "v": new_v, "step": s.step}, metrics
