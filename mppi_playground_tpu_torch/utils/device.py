"""Device resolution shared by every entry point of the port.

``device=None`` means ``"cuda"``.  Without a card, an entry point raises
instead of carrying on quietly on the CPU; the CPU runs only when the
caller asks for it (as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
