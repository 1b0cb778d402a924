"""Device resolution shared by the port's entry points, and the card's
name and power limit that every reading on the card is written beside."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``"cuda"``. A CUDA device without a GPU raises — the
    port never falls back to the CPU behind the caller's back; pass
    ``device="cpu"`` to run the plain PyTorch path on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but no CUDA GPU is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
