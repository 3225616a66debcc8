"""Checkpoint and resume for long renders.

Port of ``raytpu/io/checkpoint.py``. The render's state is its per-pixel
sums (radiance, albedo, normal) and the samples done; every draw hangs
off (pixel id, sample index), so:

  * a flush is one host copy of the sums and one ``save_checkpoint``;
  * a resume reloads the sums and hands them to ``render`` as its
    ``init`` carry, at ``sample_offset`` = samples done;
  * a resumed frame is bit-identical to an uninterrupted one: ``render``
    adds each sample to the carry in sample order, so the same terms are
    added in the same order.

The files are ``raytpu``'s: one ``.npz`` (``radiance``, ``albedo``,
``normal`` as (n_pixels, 3) f32 and ``samples_done`` int64) and a JSON
sidecar (``<path>.json``) holding the config fingerprint, both written to
a temporary name and moved into place with ``os.replace``. The
fingerprint is the same dict in both packages, so a checkpoint written
by either resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.render import (
    RenderOutput, RenderSums, assemble_image, blocked_pixel_order, render)


def _fingerprint(cfg: RenderConfig, seed: int) -> dict:
    """The settings a resume must match: every config field and the seed,
    less the execution knobs that leave the sums unchanged (``use_pallas``,
    ``pallas_interpret``, ``pixel_tile``) and less ``use_megakernel``
    except for a merged-quad scene, whose megakernel agrees with the scan
    path only up to knife-edge winner flips. Canonicalised by a JSON
    round trip (tuples come back from the sidecar as lists)."""
    d = dataclasses.asdict(cfg)
    d["seed"] = seed
    d.pop("use_pallas", None)
    d.pop("pallas_interpret", None)
    d.pop("pixel_tile", None)
    if not (cfg.merge_quads and cfg.quad_pairs):
        d.pop("use_megakernel", None)
    return json.loads(json.dumps(d))


def save_checkpoint(path: str, rad: np.ndarray, alb: np.ndarray,
                    nrm: np.ndarray, samples_done: int, cfg: RenderConfig,
                    seed: int) -> None:
    """Writes the sidecar, then the sums; each through a temporary file
    and ``os.replace``, so a crash never leaves a torn file. The sidecar
    is the same at every flush, so writing it first is always consistent."""
    tmp_json = path + ".json.tmp"
    with open(tmp_json, "w") as f:
        json.dump(_fingerprint(cfg, seed), f)
    os.replace(tmp_json, path + ".json")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp.removesuffix(".npz"), radiance=rad, albedo=alb,
                        normal=nrm, samples_done=np.int64(samples_done))
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: RenderConfig, seed: int
                    ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray,
                                        int]]:
    """(radiance, albedo, normal sums, samples done), or None when there
    is no checkpoint (or no sidecar beside it). Raises ``ValueError`` when
    it was written with other settings; a key the sidecar lacks matches
    when the current run keeps that field's default."""
    if not (os.path.exists(path) and os.path.exists(path + ".json")):
        return None
    with open(path + ".json") as f:
        meta = json.load(f)
    want = _fingerprint(cfg, seed)
    defaults = json.loads(json.dumps(dataclasses.asdict(RenderConfig())))
    diff = {k: (meta.get(k), want[k]) for k in want
            if meta.get(k, defaults.get(k)) != want[k]}
    if diff:
        raise ValueError(
            f"checkpoint {path} was written with different settings: {diff}")
    z = np.load(path)
    return z["radiance"], z["albedo"], z["normal"], int(z["samples_done"])


@torch.no_grad()
def render_image_checkpointed(
        scene: Scene, cam: Camera, cfg: RenderConfig, key: torch.Tensor,
        ckpt_path: str, flush_every: int = 64,
        log: Optional[Callable[[str], None]] = None,
        progress: Optional[Callable[[int, np.ndarray], None]] = None,
) -> RenderOutput:
    """``render_image`` that flushes its sums to ``ckpt_path`` every
    ``flush_every`` samples and resumes from it when it exists.

    Tiles as ``render_image`` does (``cfg.pixel_tile`` ids, block-major
    order, the last tile padded with the last id). Each tile of a flush
    starts from the saved sums as ``render``'s carry; its sums come back
    in one host copy. ``key`` is a ``rng.prng_key``: its last word is the
    seed the fingerprint holds. ``progress(samples_done, radiance_sums)``
    is called after every flush (the hook ``observe.RenderMonitor.update``
    attaches to), ``log(message)`` with a line of text.
    """
    n_pix = cfg.n_pixels
    seed = int(key.reshape(-1)[-1])
    state = load_checkpoint(ckpt_path, cfg, seed)
    if state is not None:
        rad, alb, nrm, done = state
        if log:
            log(f"resuming at {done}/{cfg.spp} samples from {ckpt_path}")
    else:
        rad, alb, nrm = (np.zeros((n_pix, 3), np.float32) for _ in range(3))
        done = 0

    dev = scene.device
    tile = min(cfg.pixel_tile, n_pix)
    n_tiles = (n_pix + tile - 1) // tile
    all_ids = np.pad(blocked_pixel_order(cfg), (0, n_tiles * tile - n_pix),
                     mode="edge")
    on_dev = lambda a: Vec3.from_array(torch.from_numpy(a).to(dev))
    while done < cfg.spp:
        n = min(flush_every, cfg.spp - done)
        for t in range(n_tiles):
            ids = all_ids[t * tile:(t + 1) * tile]
            init = RenderSums(on_dev(rad[ids]), on_dev(alb[ids]),
                              on_dev(nrm[ids]), done)
            sums = render(scene, cam, cfg, ids, key, sample_offset=done,
                          n_samples=n, init=init)
            planes = torch.stack([*sums.radiance, *sums.albedo,
                                  *sums.normal]).cpu().numpy()
            for k, sums_np in enumerate((rad, alb, nrm)):
                sums_np[ids] = planes[3 * k:3 * k + 3].T
        done += n
        save_checkpoint(ckpt_path, rad, alb, nrm, done, cfg, seed)
        if log:
            log(f"{done}/{cfg.spp} samples checkpointed")
        if progress:
            progress(done, rad)
    return assemble_image(cfg, rad, alb, nrm)
