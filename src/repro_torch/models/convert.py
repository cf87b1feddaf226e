"""Carry a JAX LM's parameters into this package's modules.

``params_from_jax`` takes the JAX package's dense parameter tree — the
dict ``repro.models.api.init_params`` returns, with leaves as numpy arrays
(or anything ``numpy.asarray`` accepts) and per-layer leaves stacked on a
leading layer axis — and returns a ``DenseLM`` holding the same numbers.
Layouts are kept as they are at every einsum boundary, so both packages
contract the same axes; only the dtype follows ``cfg.param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import DenseLM


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.array(src, dtype=np.float32)           # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


@torch.no_grad()
def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: torch.device = torch.device("cpu")) -> DenseLM:
    model = DenseLM(cfg, torch.device(device))
    _copy(model.embed, tree["tok"]["embed"], "tok/embed")
    if model.unembed is not None:
        _copy(model.unembed, tree["tok"]["unembed"], "tok/unembed")
    _copy(model.norm_f, tree["norm_f"], "norm_f")
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        _copy(block.norm_attn, layers["norm_attn"][i], f"layers/{i}/norm_attn")
        _copy(block.norm_mlp, layers["norm_mlp"][i], f"layers/{i}/norm_mlp")
        for name in ("wq", "wk", "wv", "wo"):
            _copy(getattr(block.attn, name), layers["attn"][name][i],
                  f"layers/{i}/attn/{name}")
        for name in ("wi_gate", "wi_up", "wo"):
            _copy(getattr(block.mlp, name), layers["mlp"][name][i],
                  f"layers/{i}/mlp/{name}")
    return model
