#!/usr/bin/env python3
"""Check and time the PyTorch port's scan kernels (RWKV6 WKV, Mamba2 SSD)
on one NVIDIA GPU (written for an H100).

    python3 tools/scan_kernels.py [--src DIR] [--turns 2]

Builds the kernels of the package under DIR (default: this checkout's
``src/``; give an unpacked older commit's ``src/`` to time its kernels on
the same card), prints what ptxas reports for the scan kernels, then
times ``kernels/rwkv6/ops.wkv`` at rwkv6-1.6b's one-shot prefill (B=2
S=2048 H=32 K=64, bf16) and ``kernels/mamba2/ops.ssd`` at zamba2-7b's
(B=1 S=4096 H=112 P=64 N=64, bf16): each output is first held against
the plain version at ``chip_smoke.py``'s limits, then timed between CUDA
events over back-to-back calls and on the card (torch.profiler), in
``--turns`` turns.  Where the package's SSD launcher takes a column part
(``kernel.layout``), the whole-head (64) and half-head (32) parts are
timed in turns as well, the layout's choice marked.  Exits non-zero where
no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba2 import kernel as ssd_kernel
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2.ref import ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"package: {Path(args.src).resolve()}", flush=True)
    lib = build.build()
    nvcc = build.find_nvcc()
    procs = {src: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(build.CSRC / src), "-o", "/dev/null"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("rwkv6.cu", "mamba2.cu")}
    for src, proc in procs.items():
        for line in proc.communicate()[0].splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas {src}] {line.strip()}", flush=True)
    print(f"library {lib.name}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)

    b, s, h, kd = 2, 2048, 32, 64
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, kd),
                                                    np.float32) * 0.5)
               .to(dev, torch.bfloat16) for _ in range(3))
    logw = torch.from_numpy((-np.exp(rng.uniform(-8.0, -4.0, (b, s, h, kd))
                                     + rng.standard_normal((b, s, h, kd))))
                            .astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.standard_normal((h, kd), np.float32)
                         * 0.5).to(dev)
    s0 = torch.zeros((b, h, kd, kd), device=dev)
    y, st = wkv_ops.wkv(r, k, v, logw, u, s0)
    y_ref, st_ref = wkv_ref(r, k, v, logw, u, s0)
    failed = check("wkv rwkv6-1.6b bf16", cs, y, y_ref, st, st_ref,
                   cs.WKV_FP32_TOL)

    p, n = 64, 64
    x = torch.from_numpy(rng.standard_normal((1, 4096, 112, p), np.float32)
                         * 0.5).to(dev, torch.bfloat16)
    B, C = (torch.from_numpy(rng.standard_normal((1, 4096, n), np.float32)
                             * 0.5).to(dev, torch.bfloat16) for _ in range(2))
    dts = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((1, 4096, 112), np.float32)).to(dev))
    A = -torch.from_numpy(rng.uniform(1.0, 16.0, 112)
                          .astype(np.float32)).to(dev)
    y_ref, st_ref = ssd_ref(x, dts, B, C, A)
    variants = {"ssd": lambda: ssd_ops.ssd(x, dts, B, C, A)}
    if hasattr(ssd_kernel, "layout"):
        chosen = ssd_kernel.layout(1, 112, n, 2).cols
        for cols in (64, 32):
            def run(cols=cols):
                return launch_ssd(build, ssd_kernel, x, dts, B, C, A, cols)
            tag = " (the layout's)" if cols == chosen else ""
            variants[f"ssd cols {cols}{tag}"] = run
    for name, fn in variants.items():
        y, st = fn()
        failed |= check(f"{name} zamba2-7b bf16", cs, y, y_ref, st, st_ref,
                        cs.SSD_FP32_TOL)
    variants["wkv"] = lambda: wkv_ops.wkv(r, k, v, logw, u, s0)
    order = list(variants)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            fn = variants[name]
            kname = "wkv_kernel" if name == "wkv" else "ssd_kernel"
            ms = cs.cuda_ms(fn)
            dev_ms = cs.device_ms(fn, kname)
            print(f"turn {turn} {name}: {ms:.6f} ms between events, "
                  f"{cs.ms_text(dev_ms)} on the card", flush=True)
    return 1 if failed else 0


def launch_ssd(build, kernel, x, dt, B, C, A, cols):
    """The SSD kernel at a column part of our choosing (the wrapper takes
    the layout's): one launch on the current stream, as kernel.ssd_fwd."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = build.library().mamba2_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
        None, y.data_ptr(), h_fin.data_ptr(), b, s, h, p, n, cols,
        kernel.smem_bytes(n, cols, x.element_size()),
        kernel.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mamba2")
    return y, h_fin


def check(label, cs, y, y_ref, st, st_ref, tol) -> bool:
    """chip_smoke.scan_errors, printed; True where it failed (the timings
    still run, so one call shows every variant)."""
    try:
        err, ratio = cs.scan_errors(label, y, y_ref, st, st_ref, tol)
    except AssertionError as e:
        print(f"{label}: FAILED {e}", flush=True)
        return True
    print(f"{label}: err {err:.3g} ({ratio:.3f} of the limit)", flush=True)
    return False


if __name__ == "__main__":
    sys.exit(main())
