"""Learned denoiser: a small kernel-predicting CNN (KPCN).

Port of ``raytpu/denoise/learned.py``:

    features = [log1p(max(color, 0)), albedo, normal]      (9 channels)
    x -> 4 x (Conv3x3 + ReLU), 24 channels -> Conv3x3 to 49 logits
      -> softmax over the 7x7 taps
    out[p] = sum_q w[p, q] * color[q]                      (linear color)

The convolutions are ``torch.nn.Conv2d`` layers (``raytpu`` runs them
as XLA convolutions, outside any Pallas kernel), in full f32: on a CUDA
device cuDNN would round their inputs to TF32 by default, so each call
turns TF32 off for its own convolutions (``fp32_convs``). The taps are
applied by the same shifted adds and masks as the bilateral
(``bilateral.taps``).

The shipped weights, ``weights/kpcn.npz``, are a byte-identical copy of
``raytpu``'s: flax's keys ``['params']['Conv_k']['kernel'|'bias']`` with
HWIO kernels, turned into OIHW here. ``save_params`` writes that layout,
so a file it writes loads in ``raytpu``'s ``load_params``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from raytpu_torch.core.device import resolve_device
from raytpu_torch.denoise.bilateral import taps

RADIUS = 3          # 7x7 predicted kernels, like the bilateral window
FEATURES = 24
DEPTH = 4
IN_CHANNELS = 9     # log1p(color), albedo, normal

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights", "kpcn.npz")


def fp32_convs(device: torch.device):
    """A context in which cuDNN convolutions on ``device`` run in full
    f32 (TF32 off), the other cuDNN flags kept; nothing on the CPU.
    ``cudnn.flags`` resets each flag it is not given to its own default
    (``enabled`` to False), so each is passed its current value."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       benchmark_limit=cudnn.benchmark_limit,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class KPCN(torch.nn.Module):
    """Per-pixel kernel predictor over (color, albedo, normal); the
    convolutions ``convs[0..DEPTH]`` are flax's ``Conv_0 .. Conv_4``.
    Its weights live on ``device`` (None: the CUDA card), which must be
    the images' own."""

    def __init__(self, device=None):
        super().__init__()
        self.radius = RADIUS
        widths = [IN_CHANNELS] + [FEATURES] * DEPTH + [(2 * RADIUS + 1) ** 2]
        dev = resolve_device(device)
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv2d(i, o, 3, padding=1, device=dev)
            for i, o in zip(widths, widths[1:]))

    def forward(self, color: Tensor, albedo: Tensor, normal: Tensor) -> Tensor:
        """(H, W, 3) images on the weights' device -> the (H, W, 3)
        filtered color."""
        x = torch.cat([torch.log1p(torch.clamp(color, min=0.0)), albedo,
                       normal], -1).permute(2, 0, 1)[None]
        last = len(self.convs) - 1
        with fp32_convs(color.device):
            for k, conv in enumerate(self.convs):
                x = conv(x)
                if k < last:
                    x = F.relu(x)
        weights = torch.softmax(x[0].permute(1, 2, 0), -1)   # (H, W, taps)
        return apply_kernels(color, weights, self.radius)


def apply_kernels(color: Tensor, weights: Tensor, radius: int) -> Tensor:
    """out[p] = sum over the window of w[p, q] * color[q]; the taps that
    fall outside the image are dropped and the rest renormalised."""
    num = torch.zeros_like(color)
    den = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                      device=color.device)
    for tap, (dy, dx, valid) in enumerate(taps(color, radius)):
        wq = weights[..., tap:tap + 1] * valid
        num = num + wq * torch.roll(color, (dy, dx), (0, 1))
        den = den + wq
    return num / torch.clamp(den, min=1e-8)


def _key(k: int, leaf: str) -> str:
    """flax's flattened name of convolution ``k``'s ``leaf``."""
    return f"['params']['Conv_{k}']['{leaf}']"


def init_params(generator: torch.Generator, device=None) -> KPCN:
    """A freshly initialised KPCN, drawn from ``generator``: flax's
    default initialisers (kernels LeCun normal, truncated at 2 sigma;
    biases zero)."""
    model = KPCN(device=device)
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * 9
            # the std of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(conv.weight.shape)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            conv.weight.copy_(w)
            conv.bias.zero_()
    return model


def save_params(model: KPCN, path: str = WEIGHTS_PATH) -> None:
    """Writes ``model``'s weights in flax's layout (HWIO kernels)."""
    arrays = {}
    for k, conv in enumerate(model.convs):
        w = conv.weight.detach().cpu().numpy()
        arrays[_key(k, "bias")] = conv.bias.detach().cpu().numpy()
        arrays[_key(k, "kernel")] = np.ascontiguousarray(
            w.transpose(2, 3, 1, 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_params(path: str = WEIGHTS_PATH, device=None) -> Optional[KPCN]:
    """The KPCN stored at ``path``, or None when there is no file. Raises
    ``ValueError`` on a missing array or one of the wrong shape."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    model = KPCN(device=device)
    with torch.no_grad():
        for k, conv in enumerate(model.convs):
            for leaf, param, hwio in (("kernel", conv.weight, True),
                                      ("bias", conv.bias, False)):
                name = _key(k, leaf)
                if name not in z:
                    raise ValueError(f"weights file {path} is missing {name}")
                want = ((3, 3, conv.in_channels, conv.out_channels) if hwio
                        else tuple(param.shape))
                if z[name].shape != want:
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{z[name].shape} != {want}")
                a = torch.from_numpy(z[name])
                param.copy_(a.permute(3, 2, 0, 1) if hwio else a)
    return model


def denoise_learned(color: Tensor, albedo: Tensor, normal: Tensor,
                    params: Optional[KPCN] = None) -> Tensor:
    """Filters an (H, W, 3) color image with its AOVs through the KPCN,
    on their device; ``params=None`` loads the shipped weights and raises
    ``FileNotFoundError`` when there are none."""
    if params is None:
        params = load_params(WEIGHTS_PATH, device=color.device)
        if params is None:
            raise FileNotFoundError(
                f"no trained denoiser weights at {WEIGHTS_PATH}; "
                "use --denoise bilateral")
    return params(color, albedo, normal)
