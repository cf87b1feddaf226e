"""Cost walk of one eager step on meta tensors — the port's counterpart of
the JAX package's ``launch/hlo.py`` and ``launch/hlo_walker.py``.

The JAX package walks the optimized, SPMD-partitioned HLO of a compiled
step.  The port has no HLO, so it runs the step once on the meta device
under a ``TorchDispatchMode`` and walks the stream of aten ops it
dispatches, with the same ``Cost`` fields:

    flops        ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``
                 runs around the walk), so the matmul family counts
                 2·M·N·K, the HLO walker's rule for a ``dot``.  The count
                 is global; per device it is divided by the chips, which
                 assumes the work divides evenly over them.
    bytes        operand + result bytes of every op that moves data, global
                 (per device ÷ chips, as the FLOPs).  Views and metadata
                 ops are skipped (``_SKIP_OPS``'s counterpart); an op that
                 reads or writes a slice (index, gather, index_copy_,
                 index_put_) is charged twice the slice and its index, as
                 the HLO walker charges dynamic-slice/-update-slice; an
                 in-place op's own operand is counted once, as the write.
                 This is eager PyTorch's traffic — one kernel an op, no
                 fusion — not XLA's traffic at fusion boundaries.
    peak_temp    the peak of live bytes the walk allocated (the arguments
                 excluded): the temp estimate.
    coll_bytes   per-device wire bytes of the collectives the sharding plan
                 implies, under the ring/torus model of ``launch/hlo.py``
                 (k = the group's size):

                     all-reduce       2·(k-1)/k · operand_bytes
                     all-gather         (k-1)/k · result_bytes
                     reduce-scatter     (k-1)/k · operand_bytes
                     all-to-all         (k-1)/k · operand_bytes
                     collective-permute           result_bytes

The collectives are charged from the specs of the parameters
(``models/sharding.py``) where the step applies a weight.  A
``TorchFunctionMode`` sees each parameter read through ``Tensor.to`` (the
port's idiom for every weight: ``x @ w.to(dt)``, ``einsum(.., w.to(dt))``,
``bmm``, ``table.to(dt)[tokens]``, ``.T`` for a tied head) and follows that
one copy to the product it feeds:

  * a weight sharded over an axis other than "model" (FSDP's "data" in
    train, the MoE experts' "data" in serve) is all-gathered over those
    axes by each op that reads the parameter itself (its cast to the
    compute dtype, or the product where the cast is a no-op) — one gather
    a use a forward (a microbatch), a checkpointed recompute's included,
    in its storage dtype; the backward pass reuses the gathered copy;
  * a product that contracts a weight dim sharded over "model" leaves
    partial sums: an all-reduce of its output over "model" (the
    row-parallel ``wo``s, an index into a vocab-sharded embedding);
  * a product whose weight is sharded over "model" on an output dim (the
    column-parallel products) contracts that dim in its input gradient:
    an all-reduce of the input's bytes over "model", charged when the
    backward pass reaches the product's output (a gradient hook, so a
    checkpointed recompute is not charged twice);
  * the gradients (``grad_sync_cost``, train): each weight's gradient,
    once a microbatch, reduce-scattered over its FSDP axes (then
    all-reduced over "pod" on a multi-pod plan), or all-reduced over the
    batch axes where it is not FSDP-sharded.

An activation's per-device bytes are its global bytes over the batch
axes' shard count (``act_div``).  Every hop is assumed to run at NVLink's
rate (``core/energy.py::LINK_BW``); a 256-card plan spans 32 hosts of 8
cards, whose links between hosts are slower, so the collective time is a
lower bound.  Sequence parallelism (``cfg.seq_shard_train``), attention
over a sequence-sharded cache, the MoE dispatch and the vocab-sharded
softmax's small reductions are not charged.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import Spec, axis_size

aten = torch.ops.aten

# ops that allocate or describe, moving no data
_SKIP_OPS = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.lift_fresh.default,
             aten.detach.default, aten.alias.default,
             aten._local_scalar_dense.default}
# ops that read rows picked by an index: index + 2 × the rows
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# ops that write a slice (the value operand's index): index + 2 × the slice
_SLICE_WRITES = {aten.index_copy_.default: 3, aten.index_copy.default: 3,
                 aten.index_put_.default: 2, aten.index_put.default: 2,
                 aten._index_put_impl_.default: 2,
                 aten.scatter_.src: 3, aten.scatter.src: 3}


def wire_bytes(kind: str, k: int, nbytes: float) -> float:
    """Per-device wire bytes of one collective over a group of ``k`` (the
    operand's bytes, the result's for all-gather and permute)."""
    if k <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * nbytes
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (k - 1) / k * nbytes
    return float(nbytes)                 # collective-permute


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: float = 0.0
    peak_temp: float = 0.0
    warnings: List[str] = dataclasses.field(default_factory=list)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        self.n_collectives += other.n_collectives * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v * mult
        self.peak_temp = max(self.peak_temp, other.peak_temp)
        for w in other.warnings:
            if w not in self.warnings:
                self.warnings.append(w)

    def collective(self, kind: str, k: int, nbytes: float,
                   times: float = 1.0) -> None:
        """Charge ``times`` collectives of ``kind`` over ``k`` devices on
        ``nbytes`` (per device; the result's bytes for all-gather)."""
        wire = wire_bytes(kind, k, nbytes) * times
        if wire <= 0:
            return
        self.coll_bytes += wire
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + wire
        self.n_collectives += times


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class _Weight:
    """A parameter's sharding: its dims sharded over "model" (``model_k``
    devices), and the other axes its storage is cut over, which the step
    all-gathers (``gather_k`` devices)."""
    model_dims: frozenset
    model_k: int
    gather_axes: Tuple[str, ...]
    gather_k: int


def _weight(mesh: Mesh, spec: Spec) -> _Weight:
    model_dims, gather_axes = set(), []
    for i, axis in enumerate(spec):
        for a in ((axis,) if isinstance(axis, str) else axis or ()):
            if a == "model":
                model_dims.add(i)
            else:
                gather_axes.append(a)
    return _Weight(frozenset(model_dims),
                   axis_size(mesh, "model") if model_dims else 1,
                   tuple(gather_axes),
                   math.prod(axis_size(mesh, a) for a in gather_axes))


class OpWalker(TorchDispatchMode):
    """Counts one step's bytes, peak temp and FSDP gathers (FLOPs come
    from the ``FlopCounterMode`` that ``walk`` runs around it).  An op
    that reads a parameter of ``gathers`` itself (its cast to the compute
    dtype, or a product on it where that cast is a no-op) gathers it; the
    dispatch level sees a checkpointed recompute's reads too."""

    def __init__(self, gathers: Iterable[Tuple[torch.Tensor, _Weight]] = ()):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self.gathers = WeakIdKeyDictionary()
        for p, w in gathers:
            self.gathers[p] = w

    def _free(self, n: int) -> None:
        self.live -= n

    def _allocated(self, func, out) -> None:
        outs = out if isinstance(out, tuple) else (out,)
        for r, value in zip(func._schema.returns, outs):
            if r.alias_info is None:
                for t in _tensors(value):
                    n = _nbytes(t)
                    self.live += n
                    weakref.finalize(t, self._free, n)
        self.cost.peak_temp = max(self.cost.peak_temp, self.live)

    def _bytes(self, func, args, kwargs, out) -> float:
        if func in _GATHERS:
            idx = sum(_nbytes(t) for t in _tensors(args[1:]))
            return idx + 2 * sum(_nbytes(t) for t in _tensors(out))
        if func in _SLICE_WRITES:
            flat = list(args) + list(kwargs.values())
            vals = _tensors(flat[_SLICE_WRITES[func]:][:1])
            idx = sum(_nbytes(t) for t in _tensors(flat[1:_SLICE_WRITES[func]]))
            return idx + 2 * sum(_nbytes(t) for t in vals)
        written = set()
        schema = func._schema.arguments
        for a, v in zip(schema, args):
            if a.alias_info is not None and a.alias_info.is_write:
                written.update(id(t) for t in _tensors(v))
        reads = sum(_nbytes(t) for t in _tensors((args, kwargs))
                    if id(t) not in written)
        return reads + sum(_nbytes(t) for t in _tensors(out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func in _SKIP_OPS):
            self.cost.bytes += self._bytes(func, args, kwargs, out)
            for t in args:
                w = (self.gathers.get(t) if isinstance(t, torch.Tensor)
                     else None)
                if w is not None:
                    self.cost.collective("all-gather", w.gather_k,
                                         _nbytes(t) / w.model_k)
        if not func.is_view:
            self._allocated(func, out)
        return out


# ``.T``'s getter: a new method-wrapper at each access, so compared by ==
_TRANSPOSE = torch.Tensor.T.__get__
_PRODUCTS = {torch.einsum, torch.Tensor.matmul, torch.matmul, torch.bmm,
             torch.Tensor.__getitem__}


class PlanCollectives(TorchFunctionMode):
    """Charges the "model" axis's all-reduces where the step applies a
    weight (the module docstring's rules) to ``cost``.  ``weights`` pairs
    the parameters sharded over "model" with their sharding; ``act_div``
    is the batch axes' shard count of the step's activations.  Only the
    forward pass runs under a function mode (a checkpointed recompute in
    the backward pass does not), so the backward's all-reduces are charged
    by gradient hooks set in the forward."""

    def __init__(self, cost: Cost,
                 weights: Iterable[Tuple[torch.Tensor, _Weight]],
                 act_div: int):
        super().__init__()
        self.cost = cost
        self.act_div = max(int(act_div), 1)
        self.params = WeakIdKeyDictionary()
        for p, w in weights:
            self.params[p] = w
        # a read's copy -> (its weight, the copy's dims sharded over model)
        self.copies = WeakIdKeyDictionary()

    def _copy(self, t):
        return self.copies.get(t) if isinstance(t, torch.Tensor) else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.to and args[0] in self.params:
            w = self.params[args[0]]
            self.copies[out] = (w, w.model_dims)
        elif func == _TRANSPOSE and self._copy(args[0]):
            w, dims = self.copies[args[0]]
            self.copies[out] = (w, frozenset(args[0].dim() - 1 - d
                                             for d in dims))
        elif func in _PRODUCTS:
            for copy, contracted, other in self._operands(func, args):
                self._product(*copy, contracted, other, out)
        return out

    def _operands(self, func, args):
        """(copy, its contracted dims, the other operand) of each weight
        copy a product reads."""
        if func is torch.einsum:
            ops = (args[1] if len(args) == 2
                   and isinstance(args[1], (list, tuple)) else args[1:])
            subs, res = args[0].replace(" ", "").split("->")
            subs = subs.split(",")
            return [(self._copy(t), {k for k, c in enumerate(subs[i])
                                     if c not in res},
                     ops[1 - i] if len(ops) == 2 else None)
                    for i, t in enumerate(ops) if self._copy(t)]
        if func is torch.Tensor.__getitem__:        # an embedding lookup
            if self._copy(args[0]) and isinstance(args[1], torch.Tensor):
                return [(self._copy(args[0]), {0}, None)]
            return []
        a, b = args[:2]                             # matmul, bmm
        if self._copy(b):
            return [(self._copy(b), {b.dim() - 2}, a)]
        if self._copy(a):
            return [(self._copy(a), {a.dim() - 1}, b)]
        return []

    def _product(self, w: _Weight, dims, contracted, other, out) -> None:
        if dims & contracted:
            self.cost.collective("all-reduce", w.model_k,
                                 _nbytes(out) / self.act_div)
        elif (dims and isinstance(other, torch.Tensor) and other.requires_grad
              and out.requires_grad):
            n = _nbytes(other) / self.act_div
            out.register_hook(
                lambda g: self.cost.collective("all-reduce", w.model_k, n))


def walk(fn, *args, mesh: Optional[Mesh] = None,
         weights: Iterable[Tuple[torch.Tensor, Spec]] = (), act_div: int = 1,
         **kwargs) -> Tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` once (on meta tensors, as a rule) and
    return (its result, the global ``Cost`` of the ops it dispatched, with
    the plan's per-device collectives)."""
    sharded = [(p, _weight(mesh, spec)) for p, spec in weights]
    walker = OpWalker([(p, w) for p, w in sharded if w.gather_k > 1])
    plan = PlanCollectives(walker.cost, [(p, w) for p, w in sharded
                                         if w.model_k > 1], act_div)
    with FlopCounterMode(display=False) as counter, walker, plan:
        result = fn(*args, **kwargs)
    walker.cost.flops = float(counter.get_total_flops())
    return result, walker.cost


def grad_sync_cost(weights: Iterable[Tuple[torch.Tensor, Spec]], mesh: Mesh,
                   batch_axes, n_micro: int = 1) -> Cost:
    """The gradients' collectives of one train step: each weight's
    gradient (its dtype), once a microbatch, reduce-scattered over its
    non-"model" axes and all-reduced over the rest of the batch axes
    (the "pod" of a multi-pod plan), or all-reduced over the batch axes
    where it is not sharded over them."""
    cost = Cost()
    batch = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    for p, spec in weights:
        w = _weight(mesh, spec)
        full = _nbytes(p) / w.model_k
        rest = [a for a in batch if a not in w.gather_axes]
        if w.gather_axes:
            cost.collective("reduce-scatter", w.gather_k, full, n_micro)
            full /= w.gather_k
        cost.collective("all-reduce",
                        math.prod(axis_size(mesh, a) for a in rest), full,
                        n_micro)
    return cost
