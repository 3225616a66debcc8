"""A frame's pixels from its sums: the mean, the sqrt tone map clamped to
[0, 0.999], and the truncating 8-bit quantizer, on the host as the
program assembles its frame."""

from __future__ import annotations

import numpy as np
import torch


def pixels(sums: np.ndarray, spp: int) -> tuple[np.ndarray, np.ndarray]:
    """(mean radiance (P, 3) f32, canvas (P, 3) int32) of (P, 3) f32 sums."""
    mean = sums.astype(np.float32) / spp
    c = torch.from_numpy(np.ascontiguousarray(mean))
    toned = torch.sqrt(torch.clamp(c, min=0.0)).clamp(0.0, 0.999)
    canvas = torch.floor(256.0 * toned).numpy().astype(np.int32)
    return mean, canvas
