#!/usr/bin/env python3
"""Check and time the PyTorch port's router kernels (featurize, LinUCB) on
one NVIDIA GPU (written for an H100).

    python3 tools/router_kernels.py [--src DIR] [--tag NAME] [--turns 2]
                                    [--out DIR]

Builds the kernels of the package under DIR (default: this checkout's
``src/``; give an unpacked older commit's ``src/`` to time its kernels on
the same card), prints what ptxas reports for ``featurize.cu`` and
``linucb.cu``, then runs every shape of ``chip_smoke.py``'s featurize and
LinUCB phases (``featurize_cases``, ``linucb_cases``): each launcher's
output is held against the plain version at the smoke's limits (1e-5,
1e-4), then timed between CUDA events over back-to-back calls and on the
card (torch.profiler's kernel time), in ``--turns`` turns.  Where the
package's launchers take a layout (``kernel.layout``), other geometries
are timed beside the layout's choice: featurize at other block sizes and
cluster sizes, LinUCB's tiled path at d = 12.  Every row goes to
``<out>/router_kernels_<tag>.json`` (default ``build/router_kernels/``).
Exits non-zero where no CUDA device is visible or a check failed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "router_kernels"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("router_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.featurize import kernel as fk
    from repro_torch.kernels.featurize.ref import hashed_embed_ref
    from repro_torch.kernels.linucb import kernel as lk
    from repro_torch.kernels.linucb.ref import linucb_scores_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"package: {Path(args.src).resolve()} ({args.tag})", flush=True)
    lib = build.build()
    nvcc = build.find_nvcc()
    procs = {src: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(build.CSRC / src), "-o", "/dev/null"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("featurize.cu", "linucb.cu")}
    for src, proc in procs.items():
        for line in proc.communicate()[0].splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas {src}] {line.strip()}", flush=True)
    print(f"library {lib.name}", flush=True)
    dev = torch.device("cuda")
    has_layout = hasattr(fk, "layout")

    # (kind, case label, variant label, fn, plain fn, limit)
    runs, failed = [], False
    for label, ids, w, proj in cs.featurize_cases(dev):
        q, seq_l = ids.shape
        variants = {"kernel": None}
        if has_layout:
            chosen = fk.layout(q, seq_l, *proj.shape)
            for cluster, threads in ((3, 512), (3, 256), (3, 128),
                                     (3, 1024), (1, 384), (1, 768),
                                     (2, 512)):
                try:
                    lay = fk.layout(q, seq_l, *proj.shape, cluster=cluster,
                                    threads=threads)
                except ValueError:
                    continue
                mark = " (the layout's)" if lay == chosen else ""
                variants[f"cluster {cluster} threads {threads}{mark}"] = lay
            del variants["kernel"]
        for name, lay in variants.items():
            def fn(ids=ids, w=w, proj=proj, lay=lay):
                if lay is None:
                    return fk.hashed_embed_fwd(ids, w, proj)
                return fk.hashed_embed_fwd(ids, w, proj, lay)
            runs.append(("featurize", label, name, fn,
                         lambda ids=ids, w=w, proj=proj:
                         hashed_embed_ref(ids, w, proj),
                         cs.FEATURIZE_TOL, "featurize_kernel"))
    for label, *arrs in cs.linucb_cases():
        a, t, x = (torch.from_numpy(v).to(dev) for v in arrs)
        m, d, _ = a.shape
        q = 1 << max(x.shape[0] - 1, 0).bit_length()     # the wrapper's pad
        x = torch.nn.functional.pad(x, (0, 0, 0, q - x.shape[0]))
        variants = {"kernel": None}
        if has_layout:
            chosen = lk.layout(q, m, d)
            variants = {f"{chosen.path} (the layout's)": chosen}
            if chosen.path == "small":
                variants["tiled"] = lk.layout(q, m, d, path="tiled")
        for name, lay in variants.items():
            def fn(a=a, t=t, x=x, lay=lay):
                if lay is None:
                    return lk.linucb_scores_fwd(a, t, x, 0.1)
                return lk.linucb_scores_fwd(a, t, x, 0.1, lay)
            runs.append(("linucb", label, name, fn,
                         lambda a=a, t=t, x=x: linucb_scores_ref(a, t, x, 0.1),
                         cs.LINUCB_TOL, "linucb"))

    results = []
    for kind, label, name, fn, plain, tol, _ in runs:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = err <= tol and bool(torch.isfinite(out).all())
        failed |= not ok
        print(f"{kind} {label} [{name}]: err {err:.3g}"
              f"{'' if ok else f' FAILED (limit {tol})'}", flush=True)
        results.append(dict(kind=kind, case=label, variant=name, err=err,
                            ms=[], device_ms=[]))
    for turn in range(args.turns):
        order = range(len(runs)) if turn % 2 == 0 else \
            range(len(runs) - 1, -1, -1)
        for i in order:
            kind, label, name, fn, _, _, kname = runs[i]
            ms = cs.cuda_ms(fn)
            dev_ms = cs.device_ms(fn, kname)
            results[i]["ms"].append(ms)
            results[i]["device_ms"].append(dev_ms)
            print(f"turn {turn} {kind} {label} [{name}]: launcher {ms:.6f} "
                  f"ms, device {cs.ms_text(dev_ms)}", flush=True)
    for i, (kind, label, name, fn, plain, _, _) in enumerate(runs):
        if name in ("kernel",) or "layout's" in name:
            results[i]["plain_ms"] = cs.cuda_ms(plain)
    clocks = loaded_clocks(runs, cs)
    floor = dict(ms=cs.cuda_ms(cs.empty_launch),
                 device_ms=cs.device_ms(cs.empty_launch, "empty_kernel")) \
        if "empty_launch" in build._SIGNATURES else None
    if floor:
        print(f"launch floor: launcher {floor['ms']:.6f} ms, device "
              f"{cs.ms_text(floor['device_ms'])}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"router_kernels_{args.tag}.json").write_text(json.dumps(
        dict(card=smi.splitlines()[0], tag=args.tag, rows=results,
             launch_floor=floor, clocks_under_load=clocks), indent=1))
    return 1 if failed else 0


def loaded_clocks(runs, cs) -> str:
    """The card's SM clock, its maximum and the power drawn while LinUCB's
    production row (d = 128, Q = 1024, M = 64) runs back to back for about
    1.5 s, read half a second in: what its fp32 peak is under that
    load."""
    fn = next(r[3] for r in runs
              if r[0] == "linucb" and r[1] == "M=64 d=128 Q=1024")
    n = max(1, int(1.5 / max(cs.cuda_ms(fn) * 1e-3, 1e-6)))
    probe = subprocess.Popen(      # reads the card half a second in
        ["bash", "-c", "sleep 0.5; nvidia-smi --query-gpu=clocks.sm,"
         "clocks.max.sm,power.draw --format=csv,noheader"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        fn()
    out = probe.communicate()[0].strip()
    torch.cuda.synchronize()
    print(f"linucb M=64 d=128 Q=1024, {n} launches back to back: SM clock, "
          f"its maximum, power drawn: {out}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
