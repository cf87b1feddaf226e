#!/usr/bin/env python3
"""Where the featurization kernel of the PyTorch port spends a launch, on
one NVIDIA GPU (written for an H100).

    python3 tools/featurize_phase_cuts.py

Copies ``csrc/featurize.cu`` into ``build/featurize_cuts/`` once per cut,
each copy returning (every thread of every block alike) at the start of
one phase: before anything ("start": the launch and the cluster's
scheduling), before the compaction (zeroing and scatter done), before the
product (the list built), before the combine (the product done); "whole"
is the kernel as it is.  Each copy is built into a library of its own
with ``nvcc`` and launched through its own ``featurize_launch`` at the
layout's geometry on ``chip_smoke.py``'s featurize shapes; the card's
time per launch (torch.profiler) of each cut is printed, so a phase costs
the difference between its cut and the next.  The outputs of the cut
copies are not checked (``tools/router_kernels.py`` and ``chip_smoke.py``
check the kernel).  Exits non-zero where no CUDA device is visible.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "featurize_cuts"
# the comment lines that open each phase, in order
CUTS = {"start": "  cg::cluster_group cluster = cg::this_cluster();\n",
        "scatter done": "  // compaction: thread t owns buckets",
        "list built": "  // the product over the list:",
        "product done": "  // combine the groups in order:"}
CASES = ("mode=both Q=1", "mode=full Q=1", "mode=both Q=16",
         "mode=both Q=64", "mode=both Q=256")


def cut_source(marker: str) -> str:
    src = (CSRC / "featurize.cu").read_text()
    if src.count(marker) != 1:
        raise RuntimeError(f"featurize.cu: phase marker {marker!r} not "
                           f"found once")
    at = src.index(marker)
    if marker.startswith("  cg::"):       # return after the cluster handle
        at += len(marker)
    return src[:at] + "  return;\n" + src[at:]


def build_cuts(build) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.HEADERS:
        (OUT / header).write_bytes((CSRC / header).read_bytes())
    nvcc = build.find_nvcc()
    sources = {name: cut_source(marker) for name, marker in CUTS.items()}
    libs, procs = {}, {}
    for i, (name, src) in enumerate(sources.items()):
        cu = OUT / f"featurize_cut{i}.cu"
        cu.write_text(src)
        libs[name] = OUT / f"libfeaturize_cut{i}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(libs[name])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} cut:\n{log}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.featurize_launch.argtypes = list(
            build._SIGNATURES["featurize_launch"])
        lib.featurize_launch.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def main() -> int:
    if not torch.cuda.is_available():
        print("featurize_phase_cuts: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.featurize import kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = build_cuts(build)
    libs["whole"] = build.library()
    dev = torch.device("cuda")
    for label, ids, w, proj in cs.featurize_cases(dev):
        if label not in CASES:
            continue
        q, seq_l = ids.shape
        hash_dim, dim = proj.shape
        lay = kernel.layout(q, seq_l, hash_dim, dim)
        out = torch.empty((q, dim), device=dev)
        times = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                build.check(lib.featurize_launch(
                    ids.data_ptr(), w.data_ptr(), proj.data_ptr(),
                    out.data_ptr(), q, seq_l, hash_dim, dim, lay.threads,
                    lay.cluster, torch.cuda.current_stream().cuda_stream),
                    "featurize (cut)")
            times[name] = cs.device_ms(launch, "featurize_kernel")
        print(f"featurize {label} ({q}x{seq_l}; {lay}): " + ", ".join(
            f"{name} {cs.ms_text(t)}" for name, t in times.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
