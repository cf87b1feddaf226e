"""Sharding policy: the partition spec of every parameter, cache entry,
batch input and activation on a device mesh — the port of the JAX
package's ``models/sharding.py``.

Parallelism plan over mesh axes ("pod", "data", "model"):

  train:  batch over ("pod","data"); TP over "model" (heads / d_ff / vocab);
          FSDP weight+optimizer storage over "data" (a layer's weights
          all-gathered where it runs); MoE = expert-TP (expert hidden over
          "model"), no all-to-all.
  serve:  batch over "data" when divisible; KV cache sequence over "model"
          (and over ("data","model") when batch=1, e.g. long_500k); weights
          over "model" (+ "data" for MoE expert hidden — grok's 618GB of
          experts must spread over all 256 chips).

Every rule degrades gracefully: if a dim isn't divisible by its assigned
axis, that dim falls back to replication (``_fit``) — this is how
kv_heads=8 archs and llava's 56 heads stay placeable on a 16-wide model
axis.

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names, or None (replicated), as ``jax.sharding.PartitionSpec``
holds them.  The mesh is ``launch/mesh.py::Mesh``, usually a production
plan.  There is no ``shard_fn``: nothing here places a tensor.  The
specs are read by the cost walk (``launch/dryrun.py``,
``launch/op_walker.py``), which charges the collectives and the
per-device bytes they imply, and the train step reads its batch specs
to give each rank of a mesh of ranks its rows (``train/step.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_items, tree_set

AxisName = Any  # str | tuple[str, ...] | None
Spec = Tuple[AxisName, ...]


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return int(mesh.shape[axis])


def _fit(mesh: Mesh, shape: Tuple[int, ...],
         wanted: Tuple[AxisName, ...]) -> Spec:
    """Drop axes whose size doesn't divide the corresponding dim."""
    return tuple(axis if axis is not None
                 and dim % axis_size(mesh, axis) == 0 else None
                 for dim, axis in zip(shape, wanted))


def shard_count(mesh: Mesh, spec: Spec) -> int:
    """How many pieces a tensor of this spec is cut into."""
    return math.prod(axis_size(mesh, a) for a in spec)


def _paths(tree) -> list:
    return [("/".join(path), path, leaf) for path, leaf in tree_items(tree)]


class ShardingPolicy:
    """Parameter, cache, batch and activation specs for one (cfg, mesh,
    mode)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, mode: str = "train"):
        if mode not in ("train", "serve"):
            raise ValueError(mode)
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.multi_pod = "pod" in mesh.axis_names
        self.batch_axes: AxisName = (("pod", "data") if self.multi_pod
                                     else "data")
        # FSDP storage axis for weights (train only)
        self.fsdp: Optional[str] = "data" if mode == "train" else None

    # -- parameters -----------------------------------------------------------

    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        m, fsdp = self.mesh, self.fsdp
        name = path.split("/")[-1]
        nd = len(shape)
        if nd <= 1:
            return (None,) if nd else ()
        # embeddings: vocab over model, d over data (fsdp)
        if name == "embed":
            return _fit(m, shape, ("model", fsdp))
        if name == "unembed":
            return _fit(m, shape, (fsdp, "model"))
        # attention projections (d, H, hd) / (H, hd, d) — path-scoped to
        # avoid colliding with rwkv's 2-D wk/wv and MoE's 3-D wo
        in_attn = any(k in path for k in ("attn/", "self_attn/",
                                          "cross_attn/"))
        if in_attn and name in ("wq", "wk", "wv"):
            return _fit(m, shape, (fsdp, "model", None))
        if in_attn and name == "wo":
            return _fit(m, shape, ("model", None, fsdp))
        # MoE experts (E, d, f) / (E, f, d): 2-D (d × f) sharding over
        # (data × model), which keeps the batch-sharded tokens local and
        # makes the conflict a per-layer weight gather
        if nd == 3 and name in ("wi_gate", "wi_up"):
            if self.mode == "serve":
                return _fit(m, shape, (None, "data", "model"))
            return _fit(m, shape, (None, fsdp, "model"))
        if nd == 3 and name == "wo":
            if self.mode == "serve":
                return _fit(m, shape, (None, "model", "data"))
            return _fit(m, shape, (None, "model", fsdp))
        # dense MLP (d, f) / (f, d)
        if name in ("wi_gate", "wi_up", "ck"):
            return _fit(m, shape, (fsdp, "model"))
        if name in ("wo", "cv"):
            return _fit(m, shape, ("model", fsdp))
        if name == "router":
            return _fit(m, shape, (fsdp, None))
        # mamba projections
        if name == "in_proj":
            return _fit(m, shape, (fsdp, "model"))
        if name == "out_proj":
            return _fit(m, shape, ("model", fsdp))
        if name == "conv_w":
            return _fit(m, shape, (None, "model"))
        # rwkv square projections (d, d); channel mix handled above
        if name in ("wr", "wk", "wv", "wg", "wo_tm", "cr"):
            return _fit(m, shape, (fsdp, "model"))
        if name == "lora_a_decay":
            return _fit(m, shape, (fsdp, None))
        if name == "lora_b_decay":
            return _fit(m, shape, (None, None))
        return (None,) * nd

    def param_specs(self, shape_tree) -> Any:
        """Specs of a JAX-named parameter tree (``api.param_shapes``):
        stacked layer params carry a leading n_layers dim that is never
        sharded."""
        out: dict = {}
        for name, path, leaf in _paths(shape_tree):
            shape = tuple(leaf.shape)
            if "layers" in name and shape:
                spec = (None,) + self.param_spec(name, shape[1:])
            else:
                spec = self.param_spec(name, shape)
            tree_set(out, path, spec)
        return out

    # -- activations ----------------------------------------------------------

    def _heads_divisible(self, h: int) -> bool:
        return h % axis_size(self.mesh, "model") == 0

    def act_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        cfg, m = self.cfg, self.mesh
        batch = self.batch_axes
        if name == "act_btd":          # (B, S, d)
            if cfg.seq_shard_train and len(shape) > 1 and shape[1] > 1:
                return _fit(m, shape, (batch, "model", None))
            return _fit(m, shape, (batch, None, None))
        if name == "act_btv":          # logits (B, S, V)
            return _fit(m, shape, (batch, None, "model"))
        if name == "act_bshd":         # q/out (B, S, H, hd)
            if (cfg.attn_shard == "sequence"
                    or not self._heads_divisible(shape[2])):
                return _fit(m, shape, (batch, "model", None, None))
            return _fit(m, shape, (batch, None, "model", None))
        if name == "act_bskd":         # k/v (B, S, Hk, hd)
            if (self._heads_divisible(shape[2])
                    and cfg.attn_shard != "sequence"):
                return _fit(m, shape, (batch, None, "model", None))
            return _fit(m, shape, (batch, None, None, None))
        if name == "dec_btd":          # decode activations (B, 1, d)
            return _fit(m, shape, (batch, None, None))
        if name == "dec_btv":          # decode logits (B, 1, V)
            return _fit(m, shape, (batch, None, "model"))
        return (None,) * len(shape)

    # -- decode caches --------------------------------------------------------

    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        m = self.mesh
        batch = self.batch_axes
        name = path.split("/")[-1]
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v",
                    "k_local", "v_local", "k_global", "v_global"):
            # (L|sites, B, S, Hk, hd): batch over data when divisible;
            # heads over model when they divide (the decode append stays a
            # local update); otherwise sequence over model (the append is
            # a masked where); batch=1 long-context: the sequence over
            # everything
            b, hk = shape[1], shape[3]
            if b % axis_size(m, batch) == 0 and b >= axis_size(m, batch):
                if hk % axis_size(m, "model") == 0:
                    return _fit(m, shape, (None, batch, None, "model", None))
                return _fit(m, shape, (None, batch, "model", None, None))
            return _fit(m, shape, (None, None, ("data", "model"), None,
                                   None))
        if name == "ssm":              # (L, B, H, P, N)
            return _fit(m, shape, (None, batch, "model", None, None))
        if name == "conv":             # (L, B, K-1, conv_dim)
            return _fit(m, shape, (None, batch, None, "model"))
        if name == "wkv":              # (L, B, H, K, V)
            return _fit(m, shape, (None, batch, "model", None, None))
        if name in ("shift_tm", "shift_cm"):
            return _fit(m, shape, (None, batch, None))
        if name == "length":           # per-slot lengths (B,)
            return _fit(m, shape, (batch,))
        return (None,) * len(shape)

    def kv_update_mode(self, batch: int, n_kv_heads: int) -> str:
        """'dus' when the cache S-dim stays device-local (batch+heads
        shard), else 'where' (masked elementwise append over the sharded
        S-dim)."""
        bsz = axis_size(self.mesh, self.batch_axes)
        batch_ok = batch % bsz == 0 and batch >= bsz
        heads_ok = n_kv_heads % axis_size(self.mesh, "model") == 0
        return "dus" if (batch_ok and heads_ok) else "where"

    def cache_specs(self, cache_tree) -> Any:
        out: dict = {}
        for name, path, leaf in _paths(cache_tree):
            tree_set(out, path, self.cache_spec(name, tuple(leaf.shape)))
        return out

    # -- batch inputs ---------------------------------------------------------

    def batch_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        batch = self.batch_axes
        if name in ("tokens", "labels", "loss_mask", "token"):
            return _fit(self.mesh, shape, (batch, None))
        if name in ("frames", "frontend_embeddings"):
            return _fit(self.mesh, shape, (batch, None, None))
        return (None,) * len(shape)

    def batch_specs(self, batch_tree) -> Any:
        out: dict = {}
        for _, path, leaf in _paths(batch_tree):
            tree_set(out, path, self.batch_spec(path[-1], tuple(leaf.shape)))
        return out
