"""The card's peaks and the least work of each layer, for the rooflines
and the step's share of the peak.

Peaks of one NVIDIA H100 SXM (data sheet): HBM at 3.35 TB/s; the SM's
issue limit, 4 schedulers x 32 lanes a clock on 132 SMs at 1.98 GHz,
which the data sheet's 67 TFLOP/s FP32 counts twice for an FMA. The
program's kernels are built without FMA contraction, so an operation
counted here is one issued instruction, FP32 or INT32 alike; both share
the issue limit, so their counts add.

A layer's least time is the larger of its bytes at HBM speed and its
operations at the issue limit. Its work is what the inputs need, counted
by the reference on the cell's own inputs, never by the program, and
never by the search a kernel happens to run: per live (ray, bounce) pair
the shading and one test of the winning primitive, the threefry draws
the bounces use, and for the backward the adjoint of the same. Every
search, present or future, reads the same work, so no share can pass
100% unless a byte or an operation here is counted that the inputs do
not need.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 128 * 132 * 1.98e9
# csrc/threefry.cuh's instructions: one fold_in (a hash), one draw (a
# hash and its conversion to [0, 1))
FOLD_OPS, DRAW_OPS = 73, 76
# the camera ray of one pixel from its draws (u, v 3 each, the jitter 4,
# 9 an axis for the ray, 12 for the normalisation)
CAM_OPS = 49
# FP32 operations of one ray-sphere test, and of the shading of a live
# (ray, bounce) pair with a sphere winner (its point, normal, scatter,
# refraction and accumulation)
SPHERE_TEST_OPS, SPHERE_SHADE_OPS = 33, 130
# the backward of a live pair with a sphere winner: the bounce replayed
# once (~165), its adjoint (~330) and the table's sums (14)
SPHERE_ADJOINT_OPS = 510
# the per-ray planes: origin and direction in (24 B), the key (8 B), the
# radiance, albedo and normal out (36 B), a winner index a bounce when
# recording (4 B), the cotangent of the 9 planes (36 B) and of the ray
# (24 B)
RAY_IN, KEY, PLANES_OUT, INDEX, G_IN, G_RAY = 24, 8, 36, 4, 36, 24
TABLE_ROW = 14 * 4   # one sphere's row of the table


@dataclass(frozen=True)
class Work:
    nbytes: float
    ops: float

    def __add__(self, o: "Work") -> "Work":
        return Work(self.nbytes + o.nbytes, self.ops + o.ops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.ops * k)

    @property
    def least_s(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / ISSUE_PER_S)


def sample_start(rays: float) -> Work:
    """Keys and camera rays of ``rays`` rays: the pixel id in (8 B), the
    key and the ray out; two fold_ins, four draws and the camera ray."""
    return Work(rays * (8 + KEY + RAY_IN),
                rays * (2 * FOLD_OPS + 4 * DRAW_OPS + CAM_OPS))


def sums(rays: float) -> Work:
    """``render``'s per-sample sums of the 9 planes: read both, write one."""
    return Work(rays * 3 * PLANES_OUT, rays * 9)


def sphere_bounce_loop(rays: float, live: float, draws: float,
                       n_spheres: int, bounces: int,
                       record: bool = False) -> Work:
    """The forward bounce loop over spheres."""
    nbytes = (rays * (RAY_IN + KEY + PLANES_OUT
                      + (INDEX * bounces if record else 0))
              + TABLE_ROW * n_spheres)
    return Work(nbytes, live * (SPHERE_TEST_OPS + SPHERE_SHADE_OPS)
                + draws * DRAW_OPS)


def sphere_backward(rays: float, live: float, draws: float, n_spheres: int,
                    bounces: int) -> Work:
    """The adjoint of the sphere bounce loop: rays, keys, the recorded
    winners and the cotangents in, the ray cotangents out, the table read
    and its cotangent written."""
    nbytes = (rays * (RAY_IN + KEY + INDEX * bounces + G_IN + G_RAY)
              + 2 * TABLE_ROW * n_spheres)
    return Work(nbytes, live * SPHERE_ADJOINT_OPS + draws * DRAW_OPS)
