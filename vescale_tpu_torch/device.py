"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["peak_bf16_flops", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card and raises when there is none: the CPU
    is used only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def peak_bf16_flops(device) -> Optional[float]:
    """The card's dense bf16 tensor-core peak, from its name: 989 TFLOP/s
    for an H100 SXM, 756 for an H100 PCIe; None for the CPU and for a card
    not in this table."""
    if not isinstance(device, int) and torch.device(device).type != "cuda":
        return None  # an int is a CUDA index
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None
    return 756e12 if "PCIe" in name else 989e12
