"""The (tiles, samples) device grid and the sharded render step.

Port of ``raytpu/sharding/mesh.py``. ``raytpu`` shard_maps ``render``
over a ``jax.sharding.Mesh`` and sums the samples axis with a ``psum``;
here a mesh is a (n_tiles, n_samples) grid of ``torch.device``s, each
cell renders its pixel tile at its range of global sample indices
(``render(..., sample_offset=s * spp_local, n_samples=spp_local)``), and
the samples axis is summed in a fixed order, s = 0, 1, ... A device may
repeat, the counterpart of ``raytpu``'s virtual CPU devices: the cells
on one device run one after another. Cells on distinct CUDA devices are
queued from one host thread and overlap on the devices.

Every draw is keyed by (pixel, global sample index), so any grid
computes the per-sample terms of one device's render, and the sums
agree with ``render_image``'s up to f32 summation order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.render import (RenderOutput, RenderSums,
                                            assemble_image, render)

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


class Mesh(NamedTuple):
    """A (n_tiles, n_samples) grid of devices: ``devices[t, s]`` renders
    pixel tile t at sample range s."""

    devices: np.ndarray   # (n_tiles, n_samples) object array of torch.device

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        nt, ns = self.devices.shape
        return {TILE_AXIS: nt, SAMPLE_AXIS: ns}


def make_mesh(n_tiles: Optional[int] = None, n_samples: Optional[int] = None,
              devices=None) -> Mesh:
    """A (tiles, samples) grid over ``devices`` (every CUDA device when
    None; a device may repeat). With neither factor given, all devices
    go on the samples axis, as ``raytpu``'s: every cell then renders the
    whole frame at ``spp / n`` samples."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("raytpu_torch: no CUDA device for the mesh; "
                               "pass devices=['cpu'] for the plain path")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n_tiles is None and n_samples is None:
        n_tiles, n_samples = 1, n
    elif n_tiles is None:
        n_tiles = n // n_samples
    elif n_samples is None:
        n_samples = n // n_tiles
    if n_tiles * n_samples != n:
        raise ValueError(f"mesh {n_tiles}x{n_samples} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n_tiles, n_samples))


def to_device(obj, dev: torch.device):
    """A scene or camera (any tree of dataclasses) with every tensor on
    ``dev``; tensors already there are kept, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def split_samples(cfg: RenderConfig, n_samples: int) -> int:
    """Samples a cell renders: ``cfg.spp / n_samples``, which must divide."""
    if cfg.spp % n_samples != 0:
        raise ValueError(f"spp={cfg.spp} not divisible by "
                         f"samples={n_samples}")
    return cfg.spp // n_samples


def render_sharded(scene: Scene, cam: Camera, cfg: RenderConfig, pixel_ids,
                   key: torch.Tensor, mesh: Mesh) -> RenderSums:
    """One sharded render step: ``pixel_ids`` split over the tiles axis,
    the ``cfg.spp`` samples over the samples axis with disjoint global
    sample indices, each cell's sums moved to the device of its tile's
    first cell and added there in samples order.

    Returns per-pixel sums over all ``cfg.spp`` samples (those of
    ``render`` on one device up to summation order), in ``pixel_ids``'
    order, on ``mesh.devices[0, 0]``."""
    nt, ns = mesh.devices.shape
    pixel_ids = torch.as_tensor(pixel_ids).to(torch.int64)
    b = pixel_ids.shape[0]
    if b % nt != 0:
        raise ValueError(f"pixel batch {b} not divisible by tiles={nt}")
    spp_local = split_samples(cfg, ns)
    tile = b // nt
    placed = {}   # device -> (scene, camera) on it
    tiles = []
    for t in range(nt):
        ids = pixel_ids[t * tile:(t + 1) * tile]
        total = None
        for s in range(ns):
            dev = mesh.devices[t, s]
            if dev not in placed:
                placed[dev] = (to_device(scene, dev), to_device(cam, dev))
            part = render(*placed[dev], cfg, ids, key,
                          sample_offset=s * spp_local, n_samples=spp_local)
            planes = torch.stack([*part.radiance, *part.albedo, *part.normal])
            total = planes if total is None else (
                total + planes.to(total.device))
        tiles.append(total.to(mesh.devices[0, 0]))
    sums = torch.cat(tiles, 1)
    return RenderSums(Vec3(*sums[0:3]), Vec3(*sums[3:6]), Vec3(*sums[6:9]),
                      cfg.spp)


def padded_ids(n_pixels: int, multiple: int) -> np.ndarray:
    """Pixel ids 0 .. n_pixels - 1, padded to a multiple of ``multiple``
    by repeating the last id (whose duplicates compute identical sums)."""
    padded = -(-n_pixels // multiple) * multiple
    return np.minimum(np.arange(padded, dtype=np.int64), n_pixels - 1)


@torch.no_grad()
def render_image_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                         key: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> RenderOutput:
    """Full frame over a mesh (every CUDA device on the samples axis when
    None): the sharded twin of ``integrator.render.render_image``. Pixel
    ids in order, padded to chunks of ``tile * n_tiles`` with ``tile =
    min(cfg.pixel_tile, ceil(n_pixels / n_tiles))``, one
    ``render_sharded`` step a chunk."""
    mesh = mesh if mesh is not None else make_mesh()
    nt = mesh.shape[TILE_AXIS]
    n_pix = cfg.n_pixels
    chunk = min(cfg.pixel_tile, -(-n_pix // nt)) * nt
    ids = padded_ids(n_pix, chunk)
    sums = np.zeros((9, ids.size), np.float32)
    for c in range(0, ids.size, chunk):
        part = render_sharded(scene, cam, cfg, ids[c:c + chunk], key, mesh)
        sums[:, c:c + chunk] = torch.stack(
            [*part.radiance, *part.albedo, *part.normal]).cpu().numpy()
    rad, alb, nrm = (sums[k:k + 3, :n_pix].T for k in (0, 3, 6))
    return assemble_image(cfg, rad, alb, nrm)
