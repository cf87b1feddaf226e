"""Device placement shared by every entry point of the package."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  ``None`` means CUDA, and CUDA where there is none raises — a
    run meant for the card never falls back to the CPU.

    On CUDA, float32 matrix products stay in full float32: TF32 keeps about
    three decimal digits, which would break the router kernels' 1e-5/1e-4
    parity (and with it the exact routing decisions) and the classifier
    logits, so both TF32 switches are turned off here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work — the timing boundary before a
    host clock is read (CUDA launches return before the work is done)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
