"""The index-replay backward (K2): sphere mode and mesh mode.

Port of ``raytpu/kernels/trace_scene_bwd.py`` (``_bwd_kernel`` over
``_replay_bounce`` / ``_replay_all``, entry point ``mesh_backward``). The
forward (K1 or K3 in recording mode) keeps each bounce's winner index and
AO factor; the backward replays the bounce loop from them without a
search and pulls the output cotangents back to the scene tables (spheres;
with triangles also the triangle table, the material table and the
atlas) and to the camera rays.

What the replay differentiates, and why the rest is constant:

* The winner is taken from the recorded index. Its distance is recomputed
  (``sphere_distance_one``'s grad-safe floors; Moller-Trumbore for a
  triangle), so the hit point, and with it the normal, carry gradients to
  the ray and the winner's geometry.
* A triangle's barycentric UVs reach only ``floor`` and the texel index:
  the raw b and c rows and the UVs get no cotangent, and the texel and
  the material row enter as data (their cotangents are scattered back to
  the atlas and the table by index).
* The AO factor is the recorded one: an indicator sum, piecewise constant
  in every parameter, so its gradient is zero almost everywhere.
* The draws get no cotangent: radiance and albedo are piecewise constant in
  every scattered direction, and the normal AOV is recorded only at
  bounces reached through cutouts, which do not turn the ray.
* The carried ``medium_n2`` and ``alpha_depth``, the alpha texel,
  ``alpha_const`` and the material flags enter only comparisons and the
  refracted direction's choice, which no output differentiates.
* The equirect sky (``k.sky_idx >= 0``): the replay keeps the forward's
  sky slot bookkeeping (``trace_scene.take_sky_slot``), so the carry
  grows by the slot's scale xyz and taken flag, and the output by the
  scale, whose cotangent arrives with the other nine (12 planes). The
  slot's direction and early flag are left out: they reach the image
  only through floor() and compares, so their cotangent is zero.

``replay_reference`` is the plain version: the replay under torch autograd,
the counterpart of ``_replay_all`` under ``jax.vjp``. ``sphere_backward``
(sphere scenes, after K1) and ``mesh_backward`` (mesh scenes, after K3)
are the entry points: on CUDA tensors they launch the hand-derived reverse
sweep in ``csrc/trace_scene_bwd.cu``, on CPU tensors they run the plain
version. Both modes take the rays' threefry keys ((2, B) int32) and the
kernel hashes each bounce's draws from them: sphere mode where it reads
them, in the replay and again in the reverse step; mesh mode once, ahead
of the replayed bounce. On CPU tensors the plain version takes the keys,
whose draws it reads from the eager stream (``core.rng.bounce_draws``), or
a (bounces * n_draws, B) draw buffer.

Every table cotangent the kernel returns is a sum in a fixed order (no
float atomics): two launches on the same inputs give the same bits. Mesh
mode's sums run over the blocks its card holds at once (``MESH_SMEM_BUDGET``
places the texels' share of a block's table).

Depth policy: one cap, ``MAX_BOUNCES = 48`` (the mesh backward's cap,
``raytpu/kernels/trace_scene.py:1937``), for the kernels and the plain
version alike; a direct call for deeper gradients raises
``NotImplementedError`` (``check_depth``). ``render`` sends such
renders to the scan path (``integrator/render.trace_fn``), as
``raytpu``'s mesh route falls back to its scan replay.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from raytpu_torch.core import rng
from raytpu_torch.kernels.trace_scene import (MeshKnobs, initial_carry,
                                              initial_sky, shade_bounce,
                                              take_sky_slot)
from raytpu_torch.materials.texture import UNTEXTURED_RGB

MAX_BOUNCES = 48
BIG = 3.0e38

launches = 0   # K2 launches by sphere_backward and mesh_backward
               # (CPU calls do not count)
# Mesh mode keeps a block's texel cotangents in shared memory when its
# shared memory with them is at most this many bytes (two blocks an SM of
# the card's 227 KB), else in the block's row of its scratch buffer
MESH_SMEM_BUDGET = 113 * 1024


class Tables(NamedTuple):
    """The differentiable tables the replay reads (``raytpu``'s
    ``_pack_diff``): sph (14, S), tri (25, T), mats (9, M), atlas
    (4, n_tex); a sphere scene has T = M = n_tex = 0."""

    sph: Tensor
    tri: Tensor
    mats: Tensor
    atlas: Tensor

    @staticmethod
    def of_spheres(sph: Tensor) -> "Tables":
        z = lambda rows: sph.new_zeros((rows, 0))
        return Tables(sph, z(25), z(9), z(4))


def check_depth(bounces: int) -> None:
    """Raise for gradients past the backward's bounce cap."""
    if bounces > MAX_BOUNCES:
        raise NotImplementedError(
            f"trace_scene_bwd: gradients of {bounces} bounces; the "
            f"backward replay stops at MAX_BOUNCES = {MAX_BOUNCES}"
        )


def _with_zero_column(t: Tensor) -> Tensor:
    """``t`` with a zero column appended: the row a miss, a non-winner
    lane or an index outside the table reads (``raytpu``'s all-zero
    one-hot extraction)."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1))], dim=1)


def _select_inv_sqrt(x: Tensor) -> Tensor:
    """1/sqrt(x) where x > 0, else 0, with select-based floors: a max()
    floor's backward would meet 0 * inf on the lanes it cuts."""
    return torch.where(x > 0, 1.0 / torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)


def _triangle_distance(w, o, d, k):
    """Moller-Trumbore against the winner's row ``w`` (25 channels),
    ``triangle_distance_one`` op for op: the distance, or BIG where the
    recomputed hit is invalid."""
    rox, roy, roz = o
    rdx, rdy, rdz = d
    aox, aoy, aoz = rox - w[0], roy - w[1], roz - w[2]
    daox = aoy * rdz - aoz * rdy
    daoy = aoz * rdx - aox * rdz
    daoz = aox * rdy - aoy * rdx
    det = -(rdx * w[9] + rdy * w[10] + rdz * w[11])
    inv_det = 1.0 / torch.where(det >= k.det_eps, det, 1.0)
    t_dst = (aox * w[9] + aoy * w[10] + aoz * w[11]) * inv_det
    t_u = (w[6] * daox + w[7] * daoy + w[8] * daoz) * inv_det
    t_v = -(w[3] * daox + w[4] * daoy + w[5] * daoz) * inv_det
    t_w = 1.0 - t_u - t_v
    valid = ((det >= k.det_eps) & (t_dst >= k.tri_eps) & (t_u >= k.tri_eps)
             & (t_v >= k.tri_eps) & (t_w >= k.tri_eps))
    return torch.where(valid, t_dst, BIG)


def _triangle_surface(w, p, active, tri_wins, mats, atlas, k):
    """The winner triangle's unit normal and material at hit point p:
    barycentric UVs (``u - trunc(u)`` wrap), the nearest texel of lanes
    that are active, and the material-table row (texture.h:16-88). Every
    index outside the atlas or the table reads the zero column."""
    px, py, pz = p
    tn = [w[9 + j] * _select_inv_sqrt(w[9] * w[9] + w[10] * w[10]
                                      + w[11] * w[11]) for j in range(3)]

    def area(p1x, p1y, p1z, qx, qy, qz):
        cxx = p1y * qz - p1z * qy
        cyy = p1z * qx - p1x * qz
        czz = p1x * qy - p1y * qx
        return tn[0] * cxx + tn[1] * cyy + tn[2] * czz

    area_abc = area(w[12] - w[0], w[13] - w[1], w[14] - w[2],
                    w[15] - w[0], w[16] - w[1], w[17] - w[2])
    area_pbc = area(w[12] - px, w[13] - py, w[14] - pz,
                    w[15] - px, w[16] - py, w[17] - pz)
    area_pca = area(w[15] - px, w[16] - py, w[17] - pz,
                    w[0] - px, w[1] - py, w[2] - pz)
    inv_area = 1.0 / torch.where(area_abc.abs() > 1e-20, area_abc, 1.0)
    w_a = area_pbc * inv_area
    w_b = area_pca * inv_area
    w_c = 1.0 - w_a - w_b

    def wrap(u):
        u = u - torch.trunc(u)
        return torch.where(u < 0.0, u + 1.0, u)

    uu = wrap(w_a * w[18] + w_b * w[20] + w_c * w[22])
    vv = wrap(w_a * w[19] + w_b * w[21] + w_c * w[23])
    mat_i = w[24].to(torch.int64)
    n_tex = atlas.shape[1] - 1
    if n_tex > 0:
        aw, ah = k.atlas_w, k.atlas_h
        tex_x = torch.clamp(torch.floor(uu * aw).to(torch.int64), 0, aw - 1)
        tex_y = torch.clamp(torch.floor(vv * ah).to(torch.int64), 0, ah - 1)
        tid = (tex_y + ah * mat_i) * aw + tex_x
        ok = active & tri_wins & (tid >= 0) & (tid < n_tex)
        trgb_x, trgb_y, trgb_z, t_alpha_tex = atlas[
            :, torch.where(ok, tid, n_tex)].unbind(0)
    else:
        full = lambda c: torch.full_like(px, c)
        trgb_x, trgb_y, trgb_z = map(full, UNTEXTURED_RGB)
        t_alpha_tex = full(1.0)
    n_m = mats.shape[1] - 1
    m_ok = tri_wins & (mat_i >= 0) & (mat_i < n_m)
    (temx, temy, temz, testr, trefl, tior, t_ac, t_uc,
     t_eft) = mats[:, torch.where(m_ok, mat_i, n_m)].unbind(0)
    eft = t_eft > 0.0
    return (tn, (trgb_x, trgb_y, trgb_z),
            (torch.where(eft, temx * trgb_x, temx),
             torch.where(eft, temy * trgb_y, temy),
             torch.where(eft, temz * trgb_z, temz)),
            testr, trefl, torch.where(t_uc > 0.0, t_ac, t_alpha_tex), tior)


def replay_bounce(i: int, tabs: Tables, carry, bidx: Tensor, u_d, v_d,
                  roulette, aof, k):
    """One differentiable replay bounce (``raytpu``'s ``_replay_bounce``
    op for op): recorded winner -> distance recompute -> normal and
    material -> ``shade_bounce``.

    ``tabs`` holds the tables with a zero column appended to each
    (``_with_zero_column``): sph (14, S + 1), tri (25, T + 1), mats
    (9, M + 1), atlas (4, n_tex + 1). A recorded index in [0, S) is a
    sphere, one >= S a triangle (``n_spheres + t``; T == 0 in sphere
    mode); -1 is a miss. ``k`` is a ``trace_spheres.Knobs`` in sphere mode,
    a ``MeshKnobs`` in mesh mode. With the sky slot on, ``carry`` has 26
    planes: the 22 of ``shade_bounce``, then the slot's scale xyz and
    taken flag.
    """
    stab, ttab, mats, atlas = tabs
    rox, roy, roz, rdx, rdy, rdz = carry[:6]
    active = carry[18] > 0.0
    n_s, n_t = stab.shape[1] - 1, ttab.shape[1] - 1
    sph_hit = (bidx >= 0) & (bidx < n_s)
    tri_wins = (bidx >= n_s) if n_t > 0 else torch.zeros_like(sph_hit)
    (scx, scy, scz, sr, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
     ior) = stab[:, torch.where(sph_hit, bidx, n_s).long()].unbind(0)

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
    dst = torch.where(
        s_hit & (st1 >= k.sphere_eps), st1,
        torch.where(s_hit & (st2 >= k.sphere_eps), st2, BIG),
    )
    if n_t > 0:
        w = ttab[:, torch.where(tri_wins & (bidx < n_s + n_t), bidx - n_s,
                                n_t).long()]
        dst = torch.where(tri_wins, _triangle_distance(w, carry[:3],
                                                       carry[3:6], k), dst)

    # knife-edge guard: where the recording forward rounded differently
    # (another build or device), a hit recorded within ulps of the epsilon
    # gate may recompute as invalid; it is then a miss, not a hit at t = BIG
    did_hit = (sph_hit | tri_wins) & (dst < BIG)
    safe_t = torch.where(did_hit, dst, 0.0)
    px = rox + rdx * safe_t
    py = roy + rdy * safe_t
    pz = roz + rdz * safe_t

    # outward normal; the floor is a select for the same reason as 1/(2a)
    n2s = (px - scx) ** 2 + (py - scy) ** 2 + (pz - scz) ** 2
    s_inv = torch.where(
        (n2s > 0) & did_hit & ~tri_wins,
        1.0 / torch.sqrt(torch.where(n2s > 0, n2s, 1.0)), 0.0,
    )
    nX, nY, nZ = (px - scx) * s_inv, (py - scy) * s_inv, (pz - scz) * s_inv
    if n_t > 0:
        tn, tdf, tem, testr, trefl, talpha, tior = _triangle_surface(
            w, (px, py, pz), active, tri_wins, mats, atlas, k)
        sel = lambda t, s_: torch.where(tri_wins, t, s_)
        nX, nY, nZ = sel(tn[0], nX), sel(tn[1], nY), sel(tn[2], nZ)
        dfx, dfy, dfz = sel(tdf[0], dfx), sel(tdf[1], dfy), sel(tdf[2], dfz)
        emx, emy, emz = sel(tem[0], emx), sel(tem[1], emy), sel(tem[2], emz)
        estr, refl = sel(testr, estr), sel(trefl, refl)
        alpha, ior = sel(talpha, alpha), sel(tior, ior)
    sky_on = k.sky_idx >= 0
    if sky_on:
        sky_win = did_hit & (bidx == k.sky_idx)
        emx, emy, emz = (torch.where(sky_win, 0.0, e) for e in (emx, emy, emz))
    out = shade_bounce(
        i, carry[:22], did_hit, px, py, pz, nX, nY, nZ,
        dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha, ior,
        u_d, v_d, roulette, e_scale_mult=k.e_scale_mult,
        ao_factor=aof, with_masks=sky_on, **k.shade_kw,
    )
    if not sky_on:
        return out
    out, e_ret, acc = out
    return out + take_sky_slot(carry[22:26], sky_win, e_ret, acc, estr,
                               carry[6:9], k.e_scale_mult)


def g_planes(k) -> int:
    """Cotangent planes K2 takes: radiance, albedo and normal (9), and
    with the sky slot its scale (12)."""
    return 12 if k.sky_idx >= 0 else 9


def replay_forward(tabs: Tables, rays, draws: Tensor, idx: Tensor, aof, k):
    """The replayed bounce loop; returns the (9, B) radiance/AOV planes,
    with the sky slot (12, B): those and the slot's scale."""
    padded = Tables(_with_zero_column(tabs.sph[:, :k.n_spheres]),
                    *map(_with_zero_column, tabs[1:]))
    carry = initial_carry(*rays)
    if k.sky_idx >= 0:
        carry = carry + initial_sky(rays[0], 4)
    for i in range(k.bounces):
        row = k.n_draws * i
        carry = replay_bounce(
            i, padded, carry, idx[i], draws[row], draws[row + 1],
            draws[row + 2], aof[i] if k.use_ao else None, k,
        )
    return torch.stack(carry[9:18] + carry[22:25])


def replay_reference(tabs: Tables, rays, draws: Tensor, idx: Tensor, aof,
                     g: Tensor, k):
    """Plain version of K2: ``replay_forward`` under autograd, pulled back
    with ``torch.autograd.grad``. g (9, B) is the cotangent of the
    radiance, albedo and normal planes, (12, B) with the sky slot's scale
    (``g_planes``). Returns (d_sph (14, S), d_tri
    (25, T), d_mat (9, M), d_atlas (4, n_tex), six ray cotangents (B,))."""
    check_depth(k.bounces)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (*tabs, *rays)]
        out = replay_forward(Tables(*leaves[:4]), leaves[4:], draws, idx,
                             aof, k)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip(leaves, grads)]
    return (*grads[:4], tuple(grads[4:]))


_ARGTYPES = (
    [ctypes.c_void_p] * 16          # sph tri mats atlas, ox..dz, keys, idx,
                                    # aof, g, d_rays, partial
    + [ctypes.c_int] * 9            # n_rays n_spheres n_tris n_mats n_tex
                                    # atlas_w atlas_h bounces n_draws
    + [ctypes.c_float] * 7          # sphere/det/tri eps, alpha lo/hi,
                                    # bright boost/threshold
    + [ctypes.c_int] + [ctypes.c_float]       # use_ao, e_scale_mult
    + [ctypes.c_int] + [ctypes.c_float] * 2   # hsl_on, hsl_l, hsl_s
    + [ctypes.c_int] * 2            # sky_idx, smem_budget
    + [ctypes.c_void_p] * 5         # d_sph d_tri d_mat d_atlas, stream
)


def _library():
    """(entry point, blocks) of the built library."""
    from raytpu_torch.kernels import _build

    lib = _build.load("trace_scene_bwd")
    fn, blocks = lib.raytpu_backward, lib.raytpu_backward_blocks
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    blocks.argtypes, blocks.restype = [ctypes.c_int] * 7, ctypes.c_int
    return fn, blocks


def _check(tensors, dev) -> None:
    """Raise unless each (tensor, shape, dtype) is contiguous on dev."""
    for t, shape, dtype in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"trace_scene_bwd kernel: want contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def scratch_shape(b: int, k: MeshKnobs) -> tuple[int, int]:
    """(blocks, entries) of the kernel's scratch buffer for b rays on the
    current card: a row of partial table sums a block (at least one row),
    14 S entries in sphere mode, 14 S + 6 T + 6 M + 3 n_tex in mesh mode,
    whose blocks are as many as the card holds at once."""
    n_blocks = _library()[1]
    blocks = n_blocks(b, k.n_spheres, k.n_tris, k.n_mats, k.n_tex,
                      MESH_SMEM_BUDGET, int(k.sky_idx >= 0))
    if blocks < 0:
        raise RuntimeError(f"trace_scene_bwd kernel's grid: cudaError "
                           f"{-blocks}")
    entries = 14 * k.n_spheres + (6 * (k.n_tris + k.n_mats) + 3 * k.n_tex
                                  if k.n_tris else 0)
    return max(blocks, 1), entries


def mesh_func_attrs(sky: bool) -> dict:
    """Mesh mode's attributes on the current card, as
    ``cudaFuncGetAttributes`` reports them: registers and local bytes a
    thread, static shared bytes, and the dynamic shared bytes of its last
    launch."""
    from raytpu_torch.kernels import _build

    fn = _build.load("trace_scene_bwd").raytpu_backward_mesh_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.func_attrs(fn, int(sky))


def _launch(tabs: Tables, rays, keys: Tensor, idx: Tensor, aof, g: Tensor,
            k: MeshKnobs):
    """Launch ``csrc/trace_scene_bwd.cu`` (reverse sweep, then the
    fixed-order sum over blocks of the table cotangents) on the current
    stream with the ray keys (2, B) int32: what ``replay_reference``
    returns for the keys' draws (``rng.bounce_draws``). Sphere mode where
    ``k.n_tris`` is 0."""
    global launches
    dev = tabs.sph.device
    b = rays[0].shape[0]
    rng.check_keys(keys, b, dev, "trace_scene_bwd")
    shapes = [(tabs.sph, (14, k.n_spheres), torch.float32),
              (tabs.tri, (25, k.n_tris), torch.float32),
              (tabs.mats, (9, k.n_mats), torch.float32),
              (tabs.atlas, (4, k.n_tex), torch.float32),
              *((r, (b,), torch.float32) for r in rays),
              (keys, (2, b), torch.int32),
              (idx, (k.bounces, b), torch.int32),
              (g, (g_planes(k), b), torch.float32)]
    if k.use_ao:
        shapes.append((aof, (k.bounces, b), torch.float32))
    _check(shapes, dev)
    if k.n_draws < 3:
        raise ValueError("trace_scene_bwd kernel: fewer than 3 draws a bounce")
    fn = _library()[0]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_rays, d_sph = empty(6, b), empty(14, k.n_spheres)
    d_tri, d_mat, d_atlas = empty(25, k.n_tris), empty(9, k.n_mats), empty(4, k.n_tex)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        partial = empty(*scratch_shape(b, k))
        err = fn(
            *(t.data_ptr() for t in tabs), *(t.data_ptr() for t in rays),
            keys.data_ptr(), idx.data_ptr(),
            aof.data_ptr() if k.use_ao else None, g.data_ptr(),
            d_rays.data_ptr(), partial.data_ptr(),
            b, k.n_spheres, k.n_tris, k.n_mats, k.n_tex, k.atlas_w,
            k.atlas_h, k.bounces, k.n_draws,
            k.sphere_eps, k.det_eps, k.tri_eps, k.alpha_lo, k.alpha_hi,
            k.bright_boost, k.bright_threshold, int(k.use_ao),
            k.e_scale_mult, int(k.hsl_on), k.hsl_l, k.hsl_s, k.sky_idx,
            MESH_SMEM_BUDGET, d_sph.data_ptr(), d_tri.data_ptr(),
            d_mat.data_ptr(), d_atlas.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"trace_scene_bwd kernel launch failed: cudaError {err}")
    launches += 1
    return d_sph, d_tri, d_mat, d_atlas, tuple(d_rays.unbind(0))


def sphere_backward(sph: Tensor, rays, src: Tensor, idx: Tensor, aof,
                    g: Tensor, k):
    """(d_sph (14, S), six ray cotangents) for output cotangent g (9, B),
    (12, B) with the sky slot, from the winner indices idx (bounces, B)
    int32 and, with AO, the factors aof (bounces, B) that K1 recorded, and
    the draw source K1 read (the ray keys; on CPU tensors also a draw
    buffer): ``mesh_backward`` with no triangles, materials or texels."""
    d_sph, *_, d_rays = mesh_backward(Tables.of_spheres(sph), rays, src,
                                      idx, aof, g, MeshKnobs.of_spheres(k))
    return d_sph, d_rays


def mesh_backward(tabs: Tables, rays, src: Tensor, idx: Tensor, aof,
                  g: Tensor, k):
    """(d_sph, d_tri, d_mat, d_atlas, six ray cotangents) for output
    cotangent g (9, B), (12, B) with the sky slot, from the winners idx
    (bounces, B) int32 and, with AO, the factors aof (bounces, B) that K3
    recorded, and the draw source K3 read; ``k`` is K3's ``MeshKnobs``.
    The kernel for CUDA tensors (``src`` the ray keys; every sum in a fixed
    order), the plain version for CPU tensors (``src`` the keys or a draw
    buffer)."""
    check_depth(k.bounces)
    dev = tabs.sph.device
    if dev.type == "cuda":
        return _launch(tabs, rays, src, idx, aof, g, k)
    if dev.type == "cpu":
        return replay_reference(tabs, rays,
                                rng.plain_draws(src, k.n_draws, k.bounces),
                                idx, aof, g, k)
    raise NotImplementedError(f"trace_scene_bwd: no kernel for {dev}")
