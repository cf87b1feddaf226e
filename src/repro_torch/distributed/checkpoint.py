"""Fault-tolerant checkpointing: atomic manifest, restore into a like-tree.

Layout on disk (the JAX package's, byte for byte for equal leaves):

    <dir>/step_000123/
        manifest.json        tree structure + per-leaf name/file/shape/dtype
        leaf_00000.npy ...   one file per tree leaf (host-gathered)
    <dir>/LATEST             atomic pointer (rename) to the newest step

Writes go to ``step_X.tmp/`` and are renamed into place only after the
manifest lands, so a crash mid-write can never corrupt the restore path —
the previous checkpoint stays LATEST.  Router/bandit state (plain dict of
numpy arrays) rides the same machinery as model state.

A tree is a nest of dicts (keys sorted), lists and tuples; ``None`` is an
empty subtree; everything else is a leaf — numpy arrays, torch tensors on
any device, Python and numpy scalars.  Leaf names are the key paths
rendered ``outer/inner/leaf``, the order and names ``jax.tree_util`` gives
the same tree, so a checkpoint written by either package restores in the
other.  A bf16 leaf, which numpy cannot hold, is stored as its raw bits
with "bfloat16" as its dtype in the manifest, as ``ml_dtypes`` names it.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
LATEST = "LATEST"


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path component, child) pairs of a tree node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, prefix + (key,))
    return out


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``
    (an iterator)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array written to disk, the dtype name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:    # store as raw bits (no uint16 view)
            return (t.contiguous().view(torch.int16).numpy().view(np.uint16),
                    "bfloat16")
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Atomically write ``tree`` as checkpoint ``step``; returns final path."""
    root = pathlib.Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:09d}"
    tmp = root / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    entries = []
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        entries.append({"name": name, "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "leaves": entries, "extra": extra or {}}
    # manifest written last inside tmp, then a single atomic rename
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _point_latest(root, final.name)
    return final


def _point_latest(root: pathlib.Path, name: str) -> None:
    fd, tmppath = tempfile.mkstemp(dir=root)
    with os.fdopen(fd, "w") as f:
        f.write(name)
    os.replace(tmppath, root / LATEST)


def latest_step(directory: str) -> Optional[int]:
    root = pathlib.Path(directory)
    ptr = root / LATEST
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (root / name / MANIFEST).exists():
        return None
    return int(name.split("_")[1])


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def restore(directory: str, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``; returns (tree, extra).

    Each leaf comes back in the form of ``like``'s leaf: a tensor on that
    tensor's device for a tensor leaf, else a numpy array — or, for a
    bf16 entry, which numpy cannot hold, a CPU tensor.
    ``shardings``, a tree of ``torch.device``s matching ``like``, places
    every leaf as a tensor on its device.  Missing leaves raise — a
    checkpoint must match the state it restores.
    """
    root = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = root / f"step_{step:09d}"
    manifest = json.loads((path / MANIFEST).read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    named = _flatten(like)
    placed = None
    if shardings is not None:
        placed = [d for _, d in _flatten(shardings)]
    out = []
    for i, (name, leaf) in enumerate(named):
        e = by_name.get(name)
        if e is None:
            raise KeyError(f"checkpoint {path} missing leaf {name!r}")
        arr = np.load(path / e["file"])
        if tuple(arr.shape) != _shape(leaf):
            raise ValueError(f"leaf {name!r}: checkpoint shape {arr.shape} "
                             f"!= model shape {_shape(leaf)}")
        raw = str(arr.dtype) != e["dtype"]     # raw-bits storage (bf16)
        device = (placed[i] if placed is not None
                  else leaf.device if isinstance(leaf, torch.Tensor)
                  else None)
        if raw:
            if e["dtype"] != "bfloat16":
                raise TypeError(f"leaf {name!r}: stored as {e['dtype']}, "
                                f"which this package does not read")
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            out.append(t.to(device) if device is not None else t)
        elif device is not None:
            out.append(torch.from_numpy(arr).to(device))
        else:
            out.append(arr)
    tree = _unflatten(like, iter(out))
    return tree, manifest.get("extra", {})


def prune(directory: str, keep: int = 3) -> None:
    """Retain the newest ``keep`` checkpoints (never the LATEST target)."""
    root = pathlib.Path(directory)
    steps = sorted(p for p in root.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
