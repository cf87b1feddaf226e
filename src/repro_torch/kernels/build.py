"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``: pointers
and the CUDA stream cross as ``c_void_p``, and every entry point returns
its launch's ``cudaError_t``.  The build happens at first use, one
``nvcc`` process per source started together, into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), under a name carrying
the hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags: a changed source or header is rebuilt, an unchanged one is loaded
as it is.  Nothing here runs at import time — a CPU-only host imports
every module of the package without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("featurize.cu", "linucb.cu", "moe_gating.cu",
           "flash_attention.cu", "rwkv6.cu", "mamba2.cu",
           "decode_attention.cu", "empty.cu")
# included by sources; hashed too
HEADERS = ("tma.cuh", "scan_mma.cuh", "kernel_info.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (restype is int: the cudaError_t)
_SIGNATURES = {
    "featurize_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "featurize_info": (_I, _I, _I, _I, _I, _P),
    "linucb_launch": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P),
    "linucb_info": (_I, _I, _I, _I, _P),
    "empty_launch": (_P,),
    "moe_gating_launch": (_P, _P, _P, _I, _I, _I, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "flash_attention_wgmma_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _P),
    "rwkv6_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _P),
    "rwkv6_info": (_I, _P),
    "mamba2_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P),
    "mamba2_info": (_I, _I, _I, _P),
    "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _P),
    "decode_attention_occupancy": (_I, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the CUDA kernels need the "
                           "CUDA toolkit")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (one ``nvcc -c`` each, in parallel), link them
    into one shared library, and return its path; a library whose name
    carries the current source hash is reused as it is."""
    lib = BUILD_DIR / f"libgreenserv_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        extra = ("-Xptxas", "-v") if verbose else ()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if verbose and log:
                print(f"[nvcc {src}]\n{log}", flush=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)     # atomic: a concurrent loader never
    return lib                       # sees a half-written library


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch was refused (the C entry point returned a nonzero
    ``cudaError_t``): a refused launch never runs, and a later
    synchronize would not report it.  1 (``cudaErrorInvalidValue``) is
    also what a launcher returns for a shape its kernel does not take."""
    if err:
        hint = (" (cudaErrorInvalidValue: a shape the kernel does not take)"
                if err == 1 else "")
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{err}{hint}")
