"""repro_torch — the Indexed DataFrame (Uta et al., 2021) in PyTorch and
CUDA for an NVIDIA H100, beside the JAX package ``repro`` it is held
against.

Every public constructor takes ``device=None``, meaning the CUDA card;
without one it raises.  ``device="cpu"`` runs the kernels' plain PyTorch
versions (kernels/ref.py).
"""

from repro_torch.frame import IndexedFrame
from repro_torch.core.schema import Schema

__version__ = "0.1.0"
__all__ = ["IndexedFrame", "Schema"]
