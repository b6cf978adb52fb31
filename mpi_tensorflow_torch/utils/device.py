"""Device resolution shared by every entry point of the port.

An entry point runs on ``cuda`` unless its caller asks for the CPU.  A
request for ``cuda`` on a machine without a card raises: nothing falls
back to the CPU, so a number measured "on the card" can never silently
be a CPU number.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) -> ``torch.device``.

    For ``cuda`` this also pins float32 matrix products and
    convolutions to full float32 (TF32 off), the numerics the JAX
    reference computes in; the parity and cross-check runs depend on
    it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda reports no "
                f"card; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise — every
    result names the device it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def card_line(device: torch.device):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for
    a CUDA device; None for the CPU.  A card may be capped below its
    maximum power and then runs slower under load, so every time measured
    on it is reported beside this line."""
    if device.type != "cuda":
        return None
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]
