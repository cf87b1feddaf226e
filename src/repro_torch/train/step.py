"""Step factories: train / prefill / serve, each with its placement.

Each factory returns a ``StepBundle``: the function, the placement of every
input and output on the mesh (``launch.mesh.Mesh``) and a description, as
the JAX package's bundles carry NamedShardings for ``jax.jit``.  A
placement here is a tree of ``torch.device``s of the inputs' and outputs'
structure — what ``distributed.checkpoint.restore(..., shardings=)``
takes: ``mesh.device``, this process's device (the meta device for a
production plan), on which every leaf is whole.  ``specs`` holds the
inputs' partition specs on the mesh from the bundle's ``ShardingPolicy``
(``models/sharding.py``), in ``in_shardings``' structure: what the cost
walk (``launch/dryrun.py``) reads, and what the train step reads to
place the batch over a mesh of ranks.

The train step takes (model, opt_state, batch) and returns (model,
opt_state, metrics): the model's parameters and the stacked moments are
updated in place, and the model comes back as it went in.  It turns
autograd on for its own model's parameters while it computes their
gradients and off again before it returns, so serving the same model
records no graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_get, tree_map
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.train import compress, optim
from repro_torch.train.optim import OptConfig


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    in_shardings: Any
    out_shardings: Any
    mesh: Mesh
    describe: str = ""
    policy: Optional[ShardingPolicy] = None
    specs: Any = None


def _placed(mesh: Mesh, tree: Any) -> Any:
    return tree_map(lambda _: mesh.device, tree)


def _microbatch(batch: Dict[str, Any], n_micro: int) -> List[Dict[str, Any]]:
    def split(x):
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    parts = {k: split(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in parts.items()} for i in range(n_micro)]


def _rows(batch: Dict[str, Any], specs: Dict[str, Any],
          mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of each leaf the specs split over "data"."""
    n, i = mesh.shape["data"], mesh.index("data")

    def take(x, spec):
        if not spec or spec[0] != "data":
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows over {n} ranks "
                             f"that the step was built to split evenly")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows]
    return {k: take(x, specs[k]) for k, x in batch.items()}


# a view of a reduced buffer starts where a fresh allocation would, so the
# kernels that read it (vectorized loads, multi-tensor norms) take the
# same paths, and sum in the same order, as on the tensors it replaces
_ALIGN_BYTES = 512


def _mean_over_ranks(tensors: List[torch.Tensor],
                     mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor's mean over the mesh's ranks: one all-reduce (sum) for
    each dtype over a flat buffer, then a true division by the rank
    count.  Returns views of the reduced buffers."""
    n = mesh.shape["data"]
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for j, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(j)
    for dtype, members in by_dtype.items():
        align = _ALIGN_BYTES // tensors[members[0]].element_size()
        starts, total = [], 0
        for j in members:
            starts.append(total)
            total += -(-tensors[j].numel() // align) * align
        flat = torch.zeros(total, dtype=dtype,
                           device=tensors[members[0]].device)
        for j, at in zip(members, starts):
            flat[at:at + tensors[j].numel()].copy_(tensors[j].reshape(-1))
        dist.all_reduce(flat, group=mesh.group)
        flat = optim.divide(flat, n)
        for j, at in zip(members, starts):
            out[j] = flat[at:at + tensors[j].numel()].view(tensors[j].shape)
    return out


@contextlib.contextmanager
def _grad_on(params: List[torch.nn.Parameter]):
    """Autograd on for ``params`` (and grad mode), as they were after."""
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, mesh: Mesh,
                    example_batch: Dict[str, Any],
                    opt_cfg: Optional[OptConfig] = None, n_micro: int = 1,
                    use_ef_compress: bool = False,
                    loss_chunk: int = 512) -> StepBundle:
    """Full train step: microbatched grads → (optional) int8 error-feedback
    compression → AdamW.

    Microbatches as the reference's: the batch reshaped into ``n_micro``
    slices, each slice's gradient divided by ``n_micro`` and added through
    fp32 into an accumulator of ``cfg.grad_accum_dtype``, the loss the mean
    of the slices' losses, ``ce``/``aux`` reported at ``n_micro == 1`` only.
    Compression and AdamW run leaf by leaf of the JAX-named tree (one
    quantization grid a leaf, weight decay by the stacked leaf's rank),
    over the leaf's per-layer parameters and its moments' layer slices
    at once.

    On a mesh of ranks the step is the reference's GSPMD step over
    "data": it takes the global batch, and where the policy's batch spec
    of a microbatch splits it over "data", each rank computes on its rows
    of each microbatch of the global batch; the gradients and the loss
    (``ce``, ``aux``) are then their means over the ranks (each rank's
    loss is a mean over equally many rows, and MoE dispatch groups are
    per row, so these are the global batch's), before compression,
    clipping and AdamW, which run alike on every rank.  A batch that
    "data" does not divide is replicated, as ``_fit`` has it: every rank
    computes the whole of it and nothing is reduced.  Parameters and
    moments are whole on every rank."""
    ocfg = opt_cfg or OptConfig(moment_dtype=cfg.moment_dtype)
    accum_dt = getattr(torch, cfg.grad_accum_dtype)
    policy = ShardingPolicy(cfg, mesh, "train")
    micro_specs = policy.batch_specs(
        _microbatch(dict(example_batch), n_micro)[0])
    split = mesh.spans_ranks and all(spec and spec[0] == "data"
                                     for spec in micro_specs.values())

    def grads_of(model, params, batch):
        if split:
            batch = _rows(batch, micro_specs, mesh)
        loss, aux = api.loss_fn(model, batch, cfg, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def train_step(model, opt_state, batch):
        params = [p for _, _, p in convert.jax_paths(model)]
        with _grad_on(params):
            if n_micro == 1:
                loss, aux_metrics, grads = grads_of(model, params, batch)
            else:
                grads = [torch.zeros(p.shape, dtype=accum_dt, device=p.device)
                         for p in params]
                losses = []
                for mb in _microbatch(batch, n_micro):
                    l, _, g = grads_of(model, params, mb)
                    grads = [(a.float() + optim.divide(gi.float(), n_micro))
                             .to(accum_dt) for a, gi in zip(grads, g)]
                    losses.append(l)
                loss = torch.stack(losses).mean()
                aux_metrics = {}
        with torch.no_grad():
            if split:
                k = len(grads)
                reduced = _mean_over_ranks(
                    [*grads, loss, *aux_metrics.values()], mesh)
                # the metrics outlive the step: copies, not views that
                # would hold the gradients' buffer into the next step
                grads, loss = reduced[:k], reduced[k].clone()
                aux_metrics = {name: x.clone() for name, x in
                               zip(aux_metrics, reduced[k + 1:])}
            groups = convert.leaf_groups(model)
            ef = opt_state.get("ef")
            if use_ef_compress:
                for path, stacked, members in groups:
                    leaf = tree_get(ef, path)
                    parts = list(leaf) if stacked else [leaf]
                    new_g, new_e = compress.ef_parts(
                        [grads[j] for j in members], parts)
                    for j, g in zip(members, new_g):
                        grads[j] = g
                    for dst, src in zip(parts, new_e):
                        dst.copy_(src)
            s = optim.step_scalars(opt_state["step"],
                                   torch.sqrt(optim.sum_squares(grads)), ocfg)
            for path, stacked, members in groups:
                m_leaf = tree_get(opt_state["m"], path)
                v_leaf = tree_get(opt_state["v"], path)
                ps = [params[j] for j in members]
                # the decay rule reads the rank of the JAX-named leaf: a
                # layer's (d,) norm gain is (L, d) once stacked
                optim.adamw_leaf_(
                    ps, [grads[j] for j in members],
                    list(m_leaf) if stacked else [m_leaf],
                    list(v_leaf) if stacked else [v_leaf],
                    ps[0].dim() + stacked >= 2, s, ocfg)
        new_opt = {"m": opt_state["m"], "v": opt_state["v"], "step": s.step}
        if use_ef_compress:
            new_opt["ef"] = ef
        metrics = {"loss": loss, "lr": s.lr, "grad_norm": s.grad_norm,
                   **aux_metrics}
        return model, new_opt, metrics

    shapes = api.param_shapes(cfg)
    psh = _placed(mesh, shapes)
    osh = _placed(mesh, opt_state_shapes(cfg, ocfg, use_ef_compress))
    bsh = _placed(mesh, dict(example_batch))
    pspecs = policy.param_specs(shapes)
    ospecs = {"m": pspecs, "v": pspecs, "step": ()}
    if use_ef_compress:
        ospecs["ef"] = pspecs
    metric_keys = ["loss", "lr", "grad_norm"] + (["ce", "aux"]
                                                 if n_micro == 1 else [])
    return StepBundle(
        fn=train_step, in_shardings=(psh, osh, bsh),
        out_shardings=(psh, osh, dict.fromkeys(metric_keys, mesh.device)),
        mesh=mesh,
        describe=f"train_step n_micro={n_micro} ef={use_ef_compress}",
        policy=policy,
        specs=(pspecs, ospecs, policy.batch_specs(dict(example_batch))))


def make_opt_state(cfg: ModelConfig, model, opt_cfg: Optional[OptConfig] = None,
                   use_ef_compress: bool = False) -> Dict[str, Any]:
    """Zero optimizer state for ``model`` on its device, named and stacked
    as the JAX package's (so its checkpoints cross between packages)."""
    ocfg = opt_cfg or OptConfig(moment_dtype=cfg.moment_dtype)
    device = next(model.parameters()).device
    shapes = api.param_shapes(cfg)
    state = optim.init_opt_state(shapes, ocfg, device=device)
    if use_ef_compress:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=device), shapes)
    return state


def opt_state_shapes(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None,
                     use_ef_compress: bool = False) -> Dict[str, Any]:
    ocfg = opt_cfg or OptConfig(moment_dtype=cfg.moment_dtype)
    shapes = api.param_shapes(cfg)
    tree = optim.opt_shapes(shapes, ocfg)
    if use_ef_compress:
        tree["ef"] = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device="meta"), shapes)
    return tree


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh: Mesh,
                      example_batch: Dict[str, Any]) -> StepBundle:
    def prefill_step(model, batch):
        return api.prefill(model, batch, cfg)

    shapes = api.param_shapes(cfg)
    policy = ShardingPolicy(cfg, mesh, "serve")
    return StepBundle(fn=prefill_step,
                      in_shardings=(_placed(mesh, shapes),
                                    _placed(mesh, dict(example_batch))),
                      out_shardings=mesh.device, mesh=mesh,
                      describe="prefill", policy=policy,
                      specs=(policy.param_specs(shapes),
                             policy.batch_specs(dict(example_batch))))


def make_serve_step(cfg: ModelConfig, mesh: Mesh, batch_size: int,
                    seq_len: int) -> StepBundle:
    """One-token decode against a cache of depth ``seq_len``; the cache
    append is the policy's ``kv_update_mode``."""
    policy = ShardingPolicy(cfg, mesh, "serve")
    cfg = dataclasses.replace(
        cfg, kv_update=policy.kv_update_mode(batch_size, cfg.n_kv_heads))

    def serve_step(model, cache, token):
        return api.serve_step(model, token, cache, cfg)

    shapes = api.param_shapes(cfg)
    cache = api.cache_shapes(cfg, batch_size, seq_len)
    psh = _placed(mesh, shapes)
    csh = _placed(mesh, cache)
    return StepBundle(fn=serve_step,
                      in_shardings=(psh, csh, mesh.device),
                      out_shardings=(mesh.device, csh), mesh=mesh,
                      describe=f"serve_step kv={seq_len}", policy=policy,
                      specs=(policy.param_specs(shapes),
                             policy.cache_specs(cache),
                             policy.batch_spec("token", (batch_size, 1))))
