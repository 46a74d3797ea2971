"""The device an entry point runs on, shared by ``Decoder`` and ``Encoder``.

``"cuda"`` launches the CUDA kernels and raises when no card is present;
``"cpu"`` runs their plain torch versions. Nothing moves to the CPU on its
own.
"""

from __future__ import annotations

import torch

from .result import InvalidArgumentError


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with its CUDA index filled in."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested, but torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise InvalidArgumentError(f"unsupported device: {device}")
    return device
