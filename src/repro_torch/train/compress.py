"""Gradient compression: int8 quantization with error feedback.

Two integration points, as in the JAX package:

  * ``ef_compress(grads, ef)`` — quantize each gradient leaf to int8 with a
    per-tensor scale and carry the quantization residual into the next step
    (error feedback, Seide et al. / Karimireddy et al.).  Applied at the
    gradient-accumulation boundary; the returned grads are the dequantized
    values so the optimizer math is unchanged.
  * ``compressed_psum(stacked, axis, mesh)`` — the int8 cross-replica sum:
    shared max-scale → int8 encode → int32 accumulate → dequantize.  The
    replicas are the leading dim of each leaf: all of them on one device,
    or, where ``axis`` runs across the ranks of a mesh of ranks
    (``launch/mesh.py``), each rank's block of them, as a device holds its
    shard in the reference — then the shared scale is an
    ``all_reduce(MAX)`` and the int32 sum an ``all_reduce(SUM)`` (int8
    values on the wire, carried in int32) over the mesh's group.  Every
    step is exact, so both forms are bit-equal to each other and to the
    reference's ``shard_map`` all-reduce.

Rounding is half to even in both packages (``torch.round``,
``jnp.round``), so a quantized leaf is bit-equal to the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import tree_items, tree_map, tree_set
from repro_torch.train.optim import divide

INT8_MAX = 127.0


def _scale(max_abs: torch.Tensor) -> torch.Tensor:
    return torch.clamp(divide(max_abs, INT8_MAX), min=1e-20)


def _encode(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32)."""
    g32 = g.float()
    scale = _scale(torch.max(torch.abs(g32)))
    return _encode(g32, scale), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params: Dict[str, Any]) -> Dict[str, Any]:
    """Zero error-feedback residuals matching the parameter tree."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_parts(grads: Sequence[torch.Tensor], ef: Sequence[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One leaf given as parts — its layers' slices, or the whole leaf —
    quantized as one tensor: (grads + residual) on one int8 grid, whose
    scale is the largest |value| over every part.  Returns (dequantized
    grads in the grads' dtypes, new residuals), part by part."""
    corrected = [g.float() + e for g, e in zip(grads, ef)]
    scale = _scale(torch.stack([torch.max(torch.abs(c))
                                for c in corrected]).max())
    deq = [dequantize_leaf(_encode(c, scale), scale) for c in corrected]
    return ([d.to(g.dtype) for d, g in zip(deq, grads)],
            [c - d for c, d in zip(corrected, deq)])


@torch.no_grad()
def ef_compress(grads: Dict[str, Any], ef: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize (grads + residual); residual carries what int8 dropped."""
    e_tree = dict(tree_items(ef))
    new_g: Dict[str, Any] = {}
    new_ef: Dict[str, Any] = {}
    for path, g in tree_items(grads):
        (gq,), (e,) = ef_parts([g], [e_tree[path]])
        tree_set(new_g, path, gq)
        tree_set(new_ef, path, e)
    return new_g, new_ef


@torch.no_grad()
def compressed_psum(stacked: Dict[str, Any], axis: str,
                    mesh: Mesh) -> Dict[str, Any]:
    """Sum per-replica gradients over mesh axis ``axis`` in int8.

    ``stacked`` leaves carry a leading replica dim: replica i's partial
    gradient is slice i — of the axis' size on one device; this rank's
    block of the replicas where the axis runs across ranks.  The result
    drops the leading dim and is the dequantized sum: one scale shared by
    every replica (the largest |value| of any), each replica's int8
    encoding summed in int32."""
    across = mesh.spans_ranks and axis == "data"
    n = mesh.shape[axis]

    def leaf(g: torch.Tensor) -> torch.Tensor:
        if not across and g.shape[0] != n:
            raise ValueError(f"a leaf of {g.shape[0]} replicas over axis "
                             f"{axis!r} of size {n}")
        g32 = g.float()
        amax = torch.max(torch.abs(g32))
        if across:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.group)
        scale = _scale(amax)
        total = _encode(g32, scale).to(torch.int32).sum(dim=0)
        if across:
            dist.all_reduce(total, group=mesh.group)
        return (total.float() * scale).to(g.dtype)

    return tree_map(leaf, stacked)
