"""Device resolution for every public constructor of the port.

``device=None`` means the CUDA card.  Without a card that raises: the
port never moves work to the CPU on its own.  Tests and host-side tools
pass ``device="cpu"`` explicitly, and only then do the kernels' plain
PyTorch versions run.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); otherwise
    the named device, with a CUDA index filled in so that device
    comparisons are exact."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``.  Host data (numpy arrays,
    lists) is copied there; a tensor must already be there — a CUDA tensor
    is never moved to the CPU, nor a CPU tensor to the card, behind the
    caller's back."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, expected {device}")
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
