"""Where the port's constructors put their tensors.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and raises when CUDA is absent instead of
quietly building CPU tensors; ``device="cpu"`` runs the plain PyTorch
path.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "raytpu_torch: no CUDA device; pass device='cpu' to build "
            "tensors for the plain PyTorch path"
        )
    return torch.device("cuda", torch.cuda.current_device())
