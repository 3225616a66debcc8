"""Multi-process rendering: ``torch.distributed`` init and the frame
over a process-spanning (tiles, samples) grid.

Port of ``raytpu/sharding/multihost.py``. ``raytpu`` joins
``jax.distributed`` and shard_maps over the global device list; here
each process (rank) is one cell of the grid:

  * ``init_distributed`` reads ``RAYTPU_COORDINATOR`` (host:port),
    ``RAYTPU_NUM_PROCESSES`` and ``RAYTPU_PROCESS_ID`` (arguments win),
    and calls ``torch.distributed.init_process_group`` over gloo with
    ``init_method="tcp://<coordinator>"``. Without them it is a no-op
    that returns False. A failed init raises: a process never renders
    the frame alone.
  * ``make_global_mesh`` puts rank r = t * n_samples + s at cell (t, s),
    on ``cuda:{r % device_count}`` (or the CPU): two ranks on one card
    share it.
  * ``render_image_multihost``: each rank renders its cell (its pixel
    tile at its sample range), writes its sums into a full-frame array
    that is zero where it owns no pixel, and one ``all_reduce`` (sum)
    of that host array over gloo gives every rank the frame: the tiles
    come through exactly, the samples axis is summed. The sums go to the
    host anyway; gloo lets two ranks share one card, which NCCL refuses;
    a 1200x900 frame's sums are 1,080,000 px x 9 f32 = 38.9 MB.

Every draw is keyed by (pixel, global sample index), so the frame
equals a single process's up to f32 summation order.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raytpu_torch.integrator.render import assemble_image, render
from raytpu_torch.sharding.mesh import (SAMPLE_AXIS, TILE_AXIS, Mesh,
                                        make_mesh, padded_ids, split_samples,
                                        to_device)

ENV = ("RAYTPU_COORDINATOR", "RAYTPU_NUM_PROCESSES", "RAYTPU_PROCESS_ID")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = 300.0) -> bool:
    """Join the process group (idempotent). Each field: the argument, else
    its ``RAYTPU_*`` variable. Returns True when a process group of more
    than one process is up, False when none is configured."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get(ENV[0])
    if num_processes is None and env.get(ENV[1]):
        num_processes = int(env[ENV[1]])
    if process_id is None and env.get(ENV[2]):
        process_id = int(env[ENV[2]])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"init_distributed: coordinator {coordinator_address!r}, "
            f"{num_processes!r} processes, process id {process_id!r}: set "
            f"all of {', '.join(ENV)}")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_global_mesh(n_tiles: Optional[int] = None,
                     n_samples: Optional[int] = None, device=None) -> Mesh:
    """A (tiles, samples) grid of every rank of the process group, rank r
    at cell divmod(r, n_samples), on ``cuda:{r % device_count}``, or on
    the CPU with ``device="cpu"``. With neither factor given, all ranks
    go on the samples axis."""
    world = dist.get_world_size()
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * world
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("raytpu_torch: no CUDA device for the mesh; "
                               "pass device='cpu' for the plain path")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", r % count) for r in range(world)]
    return make_mesh(n_tiles, n_samples, devices)


def global_pixel_ids(mesh: Mesh, n_pixels: int) -> np.ndarray:
    """Pixel ids 0 .. n_pixels - 1, padded (by repeating the last id) to
    a multiple of the tiles axis: tile t is the t-th equal slice."""
    return padded_ids(n_pixels, mesh.shape[TILE_AXIS])


@torch.no_grad()
def render_image_multihost(scene, cam, cfg, key,
                           mesh: Optional[Mesh] = None):
    """The full frame over the process group; every rank returns the same
    ``RenderOutput``. This rank renders its cell's tile in chunks of
    ``cfg.pixel_tile`` on its cell's device, then one ``all_reduce`` of
    the (9, n_pixels) f32 sums on the host."""
    mesh = mesh if mesh is not None else make_global_mesh(
        device=scene.device)
    nt, ns = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    if nt * ns != dist.get_world_size():
        raise ValueError(f"mesh {nt}x{ns} != {dist.get_world_size()} "
                         "processes")
    spp_local = split_samples(cfg, ns)
    t, s = divmod(dist.get_rank(), ns)
    dev = mesh.devices[t, s]
    scene, cam = to_device(scene, dev), to_device(cam, dev)
    n_pix = cfg.n_pixels
    ids = global_pixel_ids(mesh, n_pix)
    tile = ids.size // nt
    sums = torch.zeros((9, n_pix), dtype=torch.float32)
    for c in range(t * tile, (t + 1) * tile, cfg.pixel_tile):
        # positions past n_pix are the padding's repeats of the last id
        chunk = ids[c:min(c + cfg.pixel_tile, (t + 1) * tile, n_pix)]
        if chunk.size == 0:
            break
        part = render(scene, cam, cfg, chunk, key,
                      sample_offset=s * spp_local, n_samples=spp_local)
        sums[:, torch.from_numpy(chunk)] = torch.stack(
            [*part.radiance, *part.albedo, *part.normal]).cpu()
    dist.all_reduce(sums)
    rad, alb, nrm = (sums[k:k + 3].T.numpy() for k in (0, 3, 6))
    return assemble_image(cfg, rad, alb, nrm)
