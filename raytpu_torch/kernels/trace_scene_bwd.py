"""The index-replay backward (K2), sphere mode.

Port of ``raytpu/kernels/trace_scene_bwd.py`` (``_bwd_kernel`` over
``_replay_bounce`` / ``_replay_all``, entry point ``mesh_backward``) for
sphere scenes (``n_tris == 0``). The forward (K1 in recording mode) keeps
each bounce's winner index and AO factor; the backward replays the bounce
loop from them without a search and pulls the output cotangents back to
the sphere table and the camera rays.

What the replay differentiates, and why the rest is constant:

* The winner is taken from the recorded index. Its distance is recomputed
  with ``sphere_distance_one``'s grad-safe floors, so the hit point, and
  with it the normal, carry gradients to the ray and the sphere.
* The AO factor is the recorded one: an indicator sum, piecewise constant
  in every parameter, so its gradient is zero almost everywhere.
* The draws get no cotangent: radiance and albedo are piecewise constant in
  every scattered direction, and the normal AOV is recorded only at
  bounces reached through cutouts, which do not turn the ray.
* The carried ``medium_n2`` and ``alpha_depth`` enter only comparisons and
  the refracted direction, which no output differentiates.

``replay_reference`` is the plain version: the replay under torch autograd,
the counterpart of ``_replay_all`` under ``jax.vjp``. ``sphere_backward``
is the entry point: on CUDA tensors it launches the hand-derived reverse
sweep in ``csrc/trace_scene_bwd.cu``, on CPU tensors it runs the plain
version.

Depth policy: one cap, ``MAX_BOUNCES = 48`` (the mesh backward's cap,
``raytpu/kernels/trace_scene.py:1937``), for the kernel and the plain
version alike; deeper gradients raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from raytpu_torch.kernels.trace_scene import initial_carry, shade_bounce

MAX_BOUNCES = 48
BIG = 3.0e38

launches = 0   # K2 launches by sphere_backward (CPU calls do not count)


def check_depth(bounces: int) -> None:
    """Raise for gradients past the backward's bounce cap."""
    if bounces > MAX_BOUNCES:
        raise NotImplementedError(
            f"trace_scene_bwd: gradients of {bounces} bounces; the "
            f"backward replay stops at MAX_BOUNCES = {MAX_BOUNCES}"
        )


def replay_bounce(i: int, tab: Tensor, carry, bidx: Tensor, u_d, v_d,
                  roulette, aof, k):
    """One differentiable replay bounce: recorded winner -> distance
    recompute -> normal -> ``shade_bounce``.

    ``tab`` is the (14, S + 1) sphere table with a zero column S, which a
    miss (``bidx == -1``, or any index outside [0, S)) reads. ``k`` is a
    ``trace_spheres.Knobs``.
    """
    rox, roy, roz, rdx, rdy, rdz = carry[:6]
    n_s = tab.shape[1] - 1
    recorded_hit = (bidx >= 0) & (bidx < n_s)   # any other index is a miss
    (scx, scy, scz, sr, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
     ior) = tab[:, torch.where(recorded_hit, bidx, n_s).long()].unbind(0)

    # sphere_distance_one with the scan replay's floors (1e-30 / 1e-20).
    # The 1/(2a) floor is a select: a max() floor would meet 0 * inf in
    # its backward wherever a == 0.
    ocx, ocy, ocz = rox - scx, roy - scy, roz - scz
    a_q = rdx * rdx + rdy * rdy + rdz * rdz
    b_q = 2.0 * (ocx * rdx + ocy * rdy + ocz * rdz)
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = torch.sqrt(torch.clamp(disc, min=1e-30))
    inv_2a = 0.5 / torch.where(a_q > 1e-20, a_q, 1e-20)
    st1 = (-b_q - sq) * inv_2a
    st2 = (-b_q + sq) * inv_2a
    s_hit = disc > 0.0
    s_t = torch.where(
        s_hit & (st1 >= k.sphere_eps), st1,
        torch.where(s_hit & (st2 >= k.sphere_eps), st2, BIG),
    )

    # knife-edge guard: where the recording forward rounded differently
    # (another build or device), a hit recorded within ulps of the epsilon
    # gate may recompute as invalid; it is then a miss, not a hit at t = BIG
    did_hit = recorded_hit & (s_t < BIG)
    safe_t = torch.where(did_hit, s_t, 0.0)
    px = rox + rdx * safe_t
    py = roy + rdy * safe_t
    pz = roz + rdz * safe_t

    # outward normal; the floor is a select for the same reason as 1/(2a)
    n2s = (px - scx) ** 2 + (py - scy) ** 2 + (pz - scz) ** 2
    s_inv = torch.where(
        (n2s > 0) & did_hit,
        1.0 / torch.sqrt(torch.where(n2s > 0, n2s, 1.0)), 0.0,
    )
    nX, nY, nZ = (px - scx) * s_inv, (py - scy) * s_inv, (pz - scz) * s_inv
    return shade_bounce(
        i, carry, did_hit, px, py, pz, nX, nY, nZ,
        dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha, ior,
        u_d, v_d, roulette, e_scale_mult=k.e_scale_mult,
        ao_factor=aof, **k.shade_kw,
    )


def replay_forward(sph: Tensor, rays, draws: Tensor, idx: Tensor, aof, k):
    """The replayed bounce loop; returns the (9, B) radiance/AOV planes."""
    tab = torch.cat([sph[:, :k.n_spheres], torch.zeros_like(sph[:, :1])], 1)
    carry = initial_carry(*rays)
    for i in range(k.bounces):
        row = k.n_draws * i
        carry = replay_bounce(
            i, tab, carry, idx[i], draws[row], draws[row + 1],
            draws[row + 2], aof[i] if k.use_ao else None, k,
        )
    return torch.stack(carry[9:18])


def replay_reference(sph: Tensor, rays, draws: Tensor, idx: Tensor, aof,
                     g: Tensor, k):
    """Plain version of K2: ``replay_forward`` under autograd, pulled back
    with ``torch.autograd.grad``. g (9, B) is the cotangent of the
    radiance, albedo and normal planes. Returns (d_sph (14, S), six ray
    cotangents (B,))."""
    check_depth(k.bounces)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (sph, *rays)]
        out = replay_forward(leaves[0], leaves[1:], draws, idx, aof, k)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip(leaves, grads)]
    return grads[0], tuple(grads[1:])


_ARGTYPES = (
    [ctypes.c_void_p] * 13          # sph, ox..dz, draws, idx, aof, g, d_rays, partial
    + [ctypes.c_int] * 4            # n_rays, n_spheres, bounces, n_draws
    + [ctypes.c_float] * 4          # eps, alpha lo/hi, bright boost
    + [ctypes.c_float]              # bright threshold
    + [ctypes.c_int]                # use_ao
    + [ctypes.c_float]              # e_scale_mult
    + [ctypes.c_int] + [ctypes.c_float] * 2   # hsl_on, hsl_l, hsl_s
    + [ctypes.c_void_p] * 2         # d_sph, stream
)


def _library():
    from raytpu_torch.kernels import _build

    lib = _build.load("trace_scene_bwd")
    fn = lib.raytpu_sphere_backward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    blocks = lib.raytpu_sphere_backward_blocks
    blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    blocks.restype = ctypes.c_int
    return fn, blocks


def _launch(sph: Tensor, rays, draws: Tensor, idx: Tensor, aof, g: Tensor,
            k):
    """Launch ``csrc/trace_scene_bwd.cu`` (reverse sweep, then the fixed-
    order sum over blocks) on the current stream."""
    global launches
    b = rays[0].shape[0]
    dev = sph.device
    shapes = [(sph, (14, k.n_spheres), torch.float32),
              *((r, (b,), torch.float32) for r in rays),
              (draws, (k.bounces * k.n_draws, b), torch.float32),
              (idx, (k.bounces, b), torch.int32),
              (g, (9, b), torch.float32)]
    if k.use_ao:
        shapes.append((aof, (k.bounces, b), torch.float32))
    for t, shape, dtype in shapes:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"trace_scene_bwd kernel: want contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k.n_draws < 3:
        raise ValueError("trace_scene_bwd kernel: fewer than 3 draws a bounce")
    fn, n_blocks = _library()
    d_rays = torch.empty((6, b), dtype=torch.float32, device=dev)
    d_sph = torch.empty((14, k.n_spheres), dtype=torch.float32, device=dev)
    blocks = n_blocks(b, k.n_spheres)
    partial = torch.empty((max(blocks, 1), 14, k.n_spheres),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            sph.data_ptr(), *(t.data_ptr() for t in rays), draws.data_ptr(),
            idx.data_ptr(), aof.data_ptr() if k.use_ao else None,
            g.data_ptr(), d_rays.data_ptr(), partial.data_ptr(),
            b, k.n_spheres, k.bounces, k.n_draws,
            k.sphere_eps, k.alpha_lo, k.alpha_hi, k.bright_boost,
            k.bright_threshold, int(k.use_ao), k.e_scale_mult,
            int(k.hsl_on), k.hsl_l, k.hsl_s, d_sph.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"trace_scene_bwd kernel launch failed: cudaError {err}")
    launches += 1
    return d_sph, tuple(d_rays.unbind(0))


def sphere_backward(sph: Tensor, rays, draws: Tensor, idx: Tensor, aof,
                    g: Tensor, k):
    """(d_sph (14, S), six ray cotangents) for output cotangent g (9, B),
    from the winner indices idx (bounces, B) int32 and, with AO, the
    factors aof (bounces, B) that K1 recorded. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    check_depth(k.bounces)
    dev = sph.device
    if dev.type == "cuda":
        return _launch(sph, rays, draws, idx, aof, g, k)
    if dev.type == "cpu":
        return replay_reference(sph, rays, draws, idx, aof, g, k)
    raise NotImplementedError(f"trace_scene_bwd: no kernel for {dev}")
