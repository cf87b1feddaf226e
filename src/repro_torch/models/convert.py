"""Carry parameters between this package's modules and the JAX package's
parameter tree, both ways.

The JAX tree is the dict ``repro.models.api.init_params`` returns: dense
(tied embeddings included: gemma3's tree has ``tok/embed`` alone, used as
the LM head), MoE, RWKV6, Mamba2-hybrid or encoder-decoder, with every
per-layer leaf stacked on a leading layer axis (``layers``,
``enc_layers``, ``dec_layers``) and the hybrid's ``shared_attn`` block
unstacked.  The modules keep the JAX names and layouts at every einsum
boundary, so one rule maps a module parameter to its leaf
(``jax_paths``): ``embed``/``unembed`` sit under ``tok``, the index of a
``layers``-like ``ModuleList`` is the position on the stacked axis, and
every other name is the key path as it stands.

    params_from_jax(tree, cfg, device)   a new model holding the tree
    load_params_(model, tree)            the tree into an existing model
    params_to_jax(model, cfg)            the model as the JAX tree (stacked)
    to_jax_tree(model, values)           any per-parameter tensors so
                                         (gradients, moments)

Both directions are exact: values pass as they are, only the dtype
follows ``cfg.param_dtype`` on the way in.  The optimizer state and the
training checkpoints are named and stacked this way, so a ``(params,
opt)`` checkpoint written by either package restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM

Path = Tuple[str, ...]
STACKS = ("layers", "enc_layers", "dec_layers")


# ---------------------------------------------------------------------------
# Nested-dict trees
# ---------------------------------------------------------------------------


def tree_get(tree: dict, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def tree_set(tree: dict, path: Path, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def tree_items(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(key path, leaf) of every leaf of a nest of dicts."""
    if isinstance(tree, dict):
        for key, child in tree.items():
            yield from tree_items(child, prefix + (key,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# The parameter map
# ---------------------------------------------------------------------------


def jax_paths(model: nn.Module) -> List[Tuple[Path, Optional[int],
                                              nn.Parameter]]:
    """(JAX key path, position on the stacked layer axis or None for an
    unstacked leaf, parameter) for every parameter of ``model``, in
    ``named_parameters`` order (a stack's layers in index order)."""
    out = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("embed", "unembed"):
            parts.insert(0, "tok")
        idx = int(parts.pop(1)) if parts[0] in STACKS else None
        out.append((tuple(parts), idx, p))
    return out


def leaf_groups(model: nn.Module) -> List[Tuple[Path, bool, List[int]]]:
    """(JAX key path, stacked, positions in ``jax_paths(model)`` of the
    leaf's parameters, layer by layer) for every leaf of the JAX tree."""
    groups: dict = {}
    for j, (path, idx, _) in enumerate(jax_paths(model)):
        stacked, members = groups.setdefault(path, (idx is not None, []))
        if stacked and idx != len(members):
            raise ValueError(f"{'/'.join(path)}: layer {idx} out of order")
        members.append(j)
    return [(path, stacked, members)
            for path, (stacked, members) in groups.items()]


def to_jax_tree(model: nn.Module, values) -> dict:
    """The JAX tree of ``values``, one tensor per entry of
    ``jax_paths(model)`` in its order (the parameters, their gradients,
    ...): per-layer tensors stacked on a new leading axis."""
    values = list(values)
    tree: dict = {}
    for path, stacked, members in leaf_groups(model):
        leaf = (torch.stack([values[j] for j in members]) if stacked
                else values[members[0]].clone())
        tree_set(tree, path, leaf)
    return tree


def _check_layout(model: nn.Module, cfg: ModelConfig) -> None:
    if (cfg.layout == "encdec") != isinstance(model, EncDecLM):
        raise ValueError(f"{cfg.name}: layout {cfg.layout!r} does not fit a "
                         f"{type(model).__name__}")


@torch.no_grad()
def params_to_jax(model: nn.Module, cfg: ModelConfig) -> dict:
    """The model's parameters as the JAX package's tree: its key paths,
    per-layer leaves stacked on the layer axis as ``repro.models.lm``'s
    ``_stack`` stacks them, tensors on the model's device in the
    parameters' dtype (a copy: training the model on does not move it).
    On the meta device this is the tree of shapes (``api.param_shapes``).
    """
    _check_layout(model, cfg)
    return to_jax_tree(model, [p.detach() for _, _, p in jax_paths(model)])


def _as_tensor(src: Any) -> torch.Tensor:
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(np.array(src, dtype=np.float32))  # writable copy


@torch.no_grad()
def load_params_(model: nn.Module, tree: dict) -> nn.Module:
    """Copy every leaf of a JAX-named tree into ``model``'s parameters, in
    place.  Leaves are tensors on any device, numpy arrays or anything
    ``numpy.asarray`` takes; a missing leaf, a leaf the model has no
    parameter for and a shape that differs all raise."""
    want = {path for path, _ in tree_items(tree)}
    have = set()
    for path, idx, p in jax_paths(model):
        name = "/".join(path)
        if path not in want:
            raise KeyError(f"the tree has no leaf {name!r}")
        have.add(path)
        src = tree_get(tree, path)
        if idx is not None:
            name = f"{name}[{idx}]"
            src = src[idx]
        src = _as_tensor(src)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {tuple(src.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(src)
    extra = want - have
    if extra:
        raise KeyError(f"the model has no parameter for "
                       f"{sorted('/'.join(x) for x in extra)}")
    return model


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> DecoderLM:
    """The JAX tree's numbers in a ``DecoderLM`` (an ``EncDecLM`` for the
    encdec layout) on ``device`` (the card unless the caller names
    another)."""
    device = resolve_device(device)
    model = (EncDecLM(cfg, device) if cfg.layout == "encdec"
             else DecoderLM(cfg, device))
    return load_params_(model, tree)
