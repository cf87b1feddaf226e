"""Assigned input-shape cells and meta-tensor input specs for the dry run
— the port of the JAX package's ``configs/shapes.py``.

Each architecture is paired with the LM shape set (40 cells):

    train_4k      seq_len=4,096    global_batch=256   (train step)
    prefill_32k   seq_len=32,768   global_batch=32    (one-shot prefill)
    decode_32k    seq_len=32,768   global_batch=128   (serve_step, 1 new token)
    long_500k     seq_len=524,288  global_batch=1     (long-context decode)

``decode_*`` / ``long_*`` run ``serve_step`` — one new token against a
KV/state cache of seq_len — not the train step.  ``long_500k`` needs
sub-quadratic attention (``ModelConfig.sub_quadratic``); full-attention
architectures skip it.

``input_specs`` returns tensors on the meta device, of the reference's
shapes and dtypes: nothing is allocated, which is what lets a 314B model
be walked on a CPU host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    """long_500k only runs on sub-quadratic attention families."""
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """For modality-frontend archs the stub embeddings occupy part of the
    sequence budget; decoder-only text tokens fill the remainder."""
    if cfg.frontend == "vision":
        return max(seq_len - cfg.n_frontend_tokens, 1)
    return seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _frontend(cfg: ModelConfig, b: int) -> Dict[str, torch.Tensor]:
    shape = (b, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.layout == "encdec" or cfg.frontend == "audio":
        return {"frames": _meta(shape, cfg.torch_dtype())}
    if cfg.frontend == "vision":
        return {"frontend_embeddings": _meta(shape, cfg.torch_dtype())}
    return {}


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                scale_batch: int = 1) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell.

    ``scale_batch`` multiplies the global batch (multi-pod meshes double
    the data parallelism, so the global batch doubles with it)."""
    b = cell.global_batch * scale_batch
    s = cell.seq_len
    if cell.kind in ("train", "prefill"):
        st = text_len(cfg, s)
        specs: Dict[str, Any] = {"tokens": _meta((b, st), torch.int32)}
        if cell.kind == "train":
            specs["labels"] = _meta((b, st), torch.int32)
        specs.update(_frontend(cfg, b))
        return specs
    if cell.kind == "decode":
        from repro_torch.models import api
        return {"token": _meta((b, 1), torch.int32),
                "cache": api.cache_shapes(cfg, b, s)}
    raise ValueError(cell.kind)
