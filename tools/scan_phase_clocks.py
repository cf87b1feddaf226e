#!/usr/bin/env python3
"""Where the scan kernels of the PyTorch port spend a chunk, on one NVIDIA
GPU (written for an H100).

    python3 tools/scan_phase_clocks.py

Copies ``csrc/rwkv6.cu`` and ``csrc/mamba2.cu`` into ``build/scan_clocks/``
with ``clock64()`` read at the start of each phase of the chunk loop and
at its end, builds each copy into a library of its own with ``nvcc``, and
runs it once at rwkv6-1.6b's prefill (B=2 S=2048 H=32) and zamba2-7b's
(B=1 S=4096 H=112 N=64; both column layouts), in bf16 and fp32.  It
prints, per phase, the cycles a warp spends a chunk, averaged over every
warp of the grid: "end" is the loop's own overhead, "top wait" the wait
for the chunk's copies and the block barrier at the top of the loop (the
skew of the warps at it included), and every other phase runs to the
next phase's mark, its closing barrier included.  The clock reads and
their sums add a few instructions a phase; the outputs are not checked
here (``tools/scan_kernels.py`` and ``chip_smoke.py`` do).  Exits
non-zero where no CUDA device is visible.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "scan_clocks"
# the comment lines that open each phase of the chunk loop, in order
PHASES = {"rwkv6.cu": ("    // A. ", "    // B. ", "    // C. ", "    // D. ",
                      "    // E. "),
          "mamba2.cu": ("    // 1. ", "    // 2. ", "    // 3. ", "    // 4. ")}
NAMES = {"rwkv6.cu": ("A w, r a, k z", "B in-block att", "C att between",
                      "D y", "E state"),
         "mamba2.cu": ("1 decays", "2 M", "3 y", "4 state")}
LOOP = "  for (int ci = 0; ci < n_chunks; ++ci) {\n"
LOOP_END = "      write_state(ci & 1);\n    }\n  }\n"
COUNTERS = r'''
__device__ unsigned long long g_clk[16];
extern "C" int clk_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
extern "C" int clk_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
'''


def mark(i: int) -> str:
    return (f"    {{ const long long now = clock64(); clk[{i}] += now - last; "
            f"last = now; }}\n")


def instrument(name: str) -> Path:
    """A copy of the source with the phase clocks in it."""
    s = (CSRC / name).read_text()
    s = s.replace('#include "scan_mma.cuh"',
                  '#include "scan_mma.cuh"\n' + COUNTERS)
    assert LOOP in s and LOOP_END in s
    s = s.replace(LOOP, "  unsigned long long clk[8] = {0};\n"
                  "  long long last = clock64();\n" + LOOP + mark(0), 1)
    for i, text in enumerate(PHASES[name]):
        assert text in s, text
        s = s.replace(text, mark(i + 1) + text, 1)
    s = s.replace(LOOP_END, LOOP_END[:-4] + mark(len(PHASES[name]) + 1)
                  + "  }\n  if ((threadIdx.x & 31) == 0) {\n"
                  "    for (int i = 0; i < 8; ++i) atomicAdd(&g_clk[i], "
                  "clk[i]);\n    atomicAdd(&g_clk[15], 1ull);\n  }\n", 1)
    path = OUT / name
    path.write_text(s)
    return path


def compile_lib(src: Path, nvcc: str, flags) -> ctypes.CDLL:
    lib = OUT / f"lib{src.stem}_clocks.so"
    r = subprocess.run([nvcc, *flags, "-I", str(CSRC), "-shared", str(src),
                        "-o", str(lib)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    out = ctypes.CDLL(str(lib))
    out.clk_get.argtypes = [ctypes.c_void_p]
    return out


def report(lib, label: str, name: str, chunks: int) -> None:
    out = (ctypes.c_ulonglong * 16)()
    lib.clk_get(ctypes.addressof(out))
    warps = out[15]
    names = ("end", "top wait") + NAMES[name]
    per = {n: round(out[i] / warps / chunks) for i, n in enumerate(names)}
    total = round(sum(out[i] for i in range(8)) / warps / chunks)
    print(f"{label}: {warps} warps; cycles a warp a chunk {per}; total "
          f"{total}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phase_clocks: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba2 import kernel as ssd_kernel
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    libw = compile_lib(instrument("rwkv6.cu"), nvcc, build.NVCC_FLAGS)
    libs = compile_lib(instrument("mamba2.cu"), nvcc, build.NVCC_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    libw.rwkv6_launch.argtypes = [P] * 8 + [I] * 6 + [P]
    libs.mamba2_launch.argtypes = [P] * 8 + [I] * 8 + [P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(1)

    def rand(shape, scale=0.5):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(dev)

    for dt in (torch.bfloat16, torch.float32):
        code = 0 if dt == torch.float32 else 1
        b, s, h = 2, 2048, 32
        r, k, v = (rand((b, s, h, 64)).to(dt) for _ in range(3))
        logw = torch.from_numpy((-np.exp(
            rng.uniform(-8, -4, (b, s, h, 64))
            + rng.standard_normal((b, s, h, 64)))).astype(np.float32)).to(dev)
        u = rand((h, 64))
        y = torch.empty_like(r)
        sf = torch.empty((b, h, 64, 64), device=dev)
        libw.clk_reset()
        libw.rwkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          logw.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                          sf.data_ptr(), b, s, h, 64,
                          wkv_kernel.smem_bytes(r.element_size()), code,
                          stream)
        torch.cuda.synchronize()
        report(libw, f"wkv rwkv6-1.6b {dt}", "rwkv6.cu", s // 64)

        x = rand((1, 4096, 112, 64)).to(dt)
        B, C = (rand((1, 4096, 64)).to(dt) for _ in range(2))
        dts = torch.nn.functional.softplus(rand((1, 4096, 112), 1.0))
        A = -torch.from_numpy(rng.uniform(1, 16, 112).astype(np.float32)
                              ).to(dev)
        y = torch.empty_like(x)
        hf = torch.empty((1, 112, 64, 64), device=dev)
        for cols in (64, 32):
            libs.clk_reset()
            libs.mamba2_launch(x.data_ptr(), dts.data_ptr(), B.data_ptr(),
                               C.data_ptr(), A.data_ptr(), None, y.data_ptr(),
                               hf.data_ptr(), 1, 4096, 112, 64, 64, cols,
                               ssd_kernel.smem_bytes(64, cols,
                                                     x.element_size()),
                               code, stream)
            torch.cuda.synchronize()
            report(libs, f"ssd zamba2-7b {dt} cols {cols}", "mamba2.cu", 64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
