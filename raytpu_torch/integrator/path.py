"""The scan path's bounce loop: fixed-depth light transport over rays.

Port of ``raytpu/integrator/path.py`` (``TraceState``, ``init_state``,
``n_bounce_draws``, ``trace``), the reference's tracer (main.c:118-242)
with an alive mask and the ``pile.h`` IOR stack reduced to its live top,
``medium_n2`` (see ``raytpu``'s module docstring). ``raytpu``'s
``lax.scan`` over bounces is a Python loop here; every bounce runs
``integrator.hit.closest_hit`` on all rays (finished ones included, as
the scan does), then the AO probes' ``any_hit``, then the shading below,
op for op. Differentiable in every scene leaf and ray through the hit
recompute; the megakernels (K1, K3) compute the same loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from raytpu_torch.core.color import hsl_boost
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3, random_unit_vector, reflect, refract
from raytpu_torch.geometry.triangle import precompute
from raytpu_torch.integrator.hit import any_hit, closest_hit


class TraceState(NamedTuple):
    origin: Vec3
    direction: Vec3
    ray_color: Vec3      # throughput ("rayColor")
    incoming: Vec3       # accumulated radiance ("incomingLight")
    albedo: Vec3         # denoiser AOV
    normal_aov: Vec3     # denoiser AOV
    active: Tensor       # (B,) bool: the ray is still bouncing
    is_alpha: Tensor     # (B,) bool: the last event was a cutout pass-through
    alpha_depth: Tensor  # (B,) int32
    medium_n2: Tensor    # (B,) the pile.h stack reduced to its live top.n2


def init_state(origin: Vec3, direction: Vec3) -> TraceState:
    b = origin.x.shape[0]
    dev = origin.x.device
    zeros = Vec3.zeros((b,), dev)
    return TraceState(
        origin=origin, direction=direction,
        ray_color=Vec3.full((b,), 1.0, 1.0, 1.0, dev),
        incoming=zeros, albedo=zeros, normal_aov=zeros,
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        is_alpha=torch.zeros((b,), dtype=torch.bool, device=dev),
        alpha_depth=torch.zeros((b,), dtype=torch.int32, device=dev),
        # empiler(n_pile, 1.0, 1.0) (main.c:128-129): start in air
        medium_n2=torch.ones((b,), dtype=torch.float32, device=dev),
    )


def n_bounce_draws(cfg: RenderConfig) -> int:
    """U(0,1) draws consumed per bounce (diffuse u/v, roulette, AO pairs)."""
    return 3 + 2 * (cfg.ao_samples if cfg.use_ao else 0)


def bounce(scene: Scene, geom, cfg: RenderConfig, i: int, state: TraceState,
           draws: Tensor) -> TraceState:
    """Bounce ``i`` of ``trace``: the state after it. ``draws`` is that
    bounce's (n_bounce_draws(cfg), B) slice of the draws."""
    hit = closest_hit(scene, geom, state.origin, state.direction, cfg)
    mat = hit.mat
    active = state.active

    # denoiser AOV base cases (main.c:137-150)
    aov0 = active & (i == 0)
    albedo = Vec3.where(aov0, mat.diffuse, state.albedo)
    normal_aov = Vec3.where(aov0, hit.normal, state.normal_aov)
    aov_alpha = active & (state.alpha_depth == i) & state.is_alpha
    alb_alpha = Vec3.where(mat.emission_strength > 0.0, mat.emission,
                           mat.diffuse)
    albedo = Vec3.where(aov_alpha, alb_alpha, albedo)
    normal_aov = Vec3.where(aov_alpha, hit.normal, normal_aov)
    is_alpha = state.is_alpha & ~aov_alpha

    # emissive early return (main.c:154-160)
    emissive_ret = (active & hit.did_hit & (state.alpha_depth == i)
                    & (mat.emission_strength > 0.0))
    boosted = hsl_boost(mat.emission, cfg.hsl_l_factor, cfg.hsl_s_factor)
    incoming = Vec3.where(emissive_ret, boosted, state.incoming)
    albedo = Vec3.where(emissive_ret, boosted, albedo)
    normal_aov = Vec3.where(emissive_ret, hit.normal, normal_aov)
    active = active & ~emissive_ret
    live = active & hit.did_hit

    # scatter directions (main.c:162-165)
    origin_new = Vec3.where(live, hit.point, state.origin)
    diffuse_dir = (hit.normal + random_unit_vector(draws[0], draws[1])).normalize()
    reflected_dir = reflect(state.direction, hit.normal)
    diff_ref_dir = diffuse_dir.lerp(reflected_dir, mat.reflection)

    # refraction (main.c:167-193 + pile.h reduced to its live top)
    refr_case = (live & (mat.alpha <= cfg.refr_alpha_hi)
                 & (mat.alpha >= cfg.refr_alpha_lo))
    exiting = state.direction.dot(hit.normal) > 0.0
    normal_eff = Vec3.where(exiting, -hit.normal, hit.normal)
    cur_n2 = state.medium_n2
    n1 = torch.where(exiting, mat.ior, cur_n2)
    n2 = torch.where(exiting, cur_n2, mat.ior)
    medium_n2 = torch.where(refr_case & ~exiting, mat.ior, cur_n2)
    refr_dir = refract(state.direction, normal_eff, n1, n2)
    do_refract = refr_case & (draws[2] > mat.alpha)

    # opaque / cutout (main.c:195-206)
    opaque = live & (mat.alpha > cfg.refr_alpha_hi)
    cutout = live & (mat.alpha < cfg.refr_alpha_lo)
    is_alpha = torch.where(opaque, False, is_alpha)
    is_alpha = torch.where(cutout, True, is_alpha)
    alpha_depth = torch.where(cutout, state.alpha_depth + 1, state.alpha_depth)
    use_diff_ref = live & ~do_refract & ~cutout
    direction_new = Vec3.where(
        do_refract, refr_dir,
        Vec3.where(use_diff_ref, diff_ref_dir, state.direction))

    # light accumulation (main.c:208-234), the x1.3 quirk multiplying by
    # the diffuse colour twice
    accum = live & ~do_refract & ~cutout
    if cfg.use_ao:
        emitted = mat.emission * (mat.emission_strength
                                  * (cfg.ao_emission_factor * cfg.ao_intensity))
    else:
        emitted = mat.emission * mat.emission_strength
    incoming = Vec3.where(accum, incoming + emitted * state.ray_color, incoming)
    rc = state.ray_color
    bright = ((rc.x > cfg.bright_threshold) | (rc.y > cfg.bright_threshold)
              | (rc.z > cfg.bright_threshold))
    rc_bright = mat.diffuse * (mat.diffuse * (rc * cfg.bright_boost))
    rc_plain = mat.diffuse * rc
    rc_new = Vec3.where(bright, rc_bright, rc_plain)
    if cfg.use_ao:
        occ_sum = torch.zeros_like(rc.x)
        for s in range(cfg.ao_samples):
            ao_rand = random_unit_vector(draws[3 + 2 * s], draws[4 + 2 * s])
            ao_dir = (hit.normal + ao_rand).normalize()
            occ_hit = any_hit(scene, geom, hit.point, ao_dir, cfg)
            # attenuation (distance/dst)^I == 1 for a unit direction
            occ_sum = occ_sum + torch.where(occ_hit, 1.0, 0.0)
        rc_new = rc_new * (occ_sum / (cfg.ao_samples * cfg.ao_intensity))
    ray_color = Vec3.where(accum, rc_new, rc)

    # a miss ends the ray (main.c:236-238)
    active = active & hit.did_hit
    return TraceState(origin_new, direction_new, ray_color, incoming, albedo,
                      normal_aov, active, is_alpha, alpha_depth, medium_n2)


def trace(scene: Scene, cfg: RenderConfig, origin: Vec3, direction: Vec3,
          bounce_draws: Tensor) -> tuple[Vec3, Vec3, Vec3]:
    """(radiance, albedo AOV, normal AOV) for a batch of rays.

    bounce_draws: (max_bounces, n_bounce_draws(cfg), B) U(0,1) draws from
    ``rng.ray_uniforms``, as ``raytpu``'s scan consumes them."""
    geom = precompute(scene.triangles) if scene.triangles.count > 0 else None
    state = init_state(origin, direction)
    for i in range(cfg.max_bounces):
        state = bounce(scene, geom, cfg, i, state, bounce_draws[i])
    return state.incoming, state.albedo, state.normal_aov
