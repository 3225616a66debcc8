"""The least work of a mesh scene's forward bounce loop, in the units of
``work``: per live (ray, bounce) pair one test of its winner and its
shading, the draws the bounces use, the rays' bytes and the tables once.
Never the search's own tests: any search, merged or not, reads the same
work.

A sphere winner costs what it costs in ``work`` (its test and shading). A
triangle winner costs the test of one axis-aligned rect of the merged
search and its shading: the sphere's shading less the sphere's normal,
plus the triangle's unit normal, its barycentric UVs with the wrap, the
texel's index and the material's selects.
"""

from __future__ import annotations

from portbench.reference import work

# one rect test: the numerator, the two scaled in-plane coordinates (5
# each), six compares and their five ands, the diagonal's side (3), and
# the deferred division
TRI_TEST_OPS = 26
# the shading of a triangle winner: the sphere's (130) less its normal
# (12), plus the unit normal (12), the barycentric weights (three cross
# products of differences 45, three dots 15, the reciprocal and 4 more),
# the UVs and their wrap (16), the texel's index (12) and the selects of
# the material, the emission from the texture and the alpha (10)
TRI_SHADE_OPS = 130 - 12 + 12 + 64 + 16 + 12 + 10
# bytes of one triangle's table (vertices, edges, raw normal, UVs,
# material), one material's row and one texel (r g b alpha)
TRI_ROW, MAT_ROW, TEXEL = 25 * 4, 9 * 4, 4 * 4


def bounce_loop(rays: float, live: float, tri: float, draws: float,
                n_spheres: int, n_tris: int, n_mats: int,
                n_texels: int) -> work.Work:
    """The forward bounce loop over spheres and triangles: ``live`` pairs,
    ``tri`` of them with a triangle winner, ``draws`` draws."""
    nbytes = (rays * (work.RAY_IN + work.KEY + work.PLANES_OUT)
              + work.TABLE_ROW * n_spheres + TRI_ROW * n_tris
              + MAT_ROW * n_mats + TEXEL * n_texels)
    ops = ((live - tri) * (work.SPHERE_TEST_OPS + work.SPHERE_SHADE_OPS)
           + tri * (TRI_TEST_OPS + TRI_SHADE_OPS) + draws * work.DRAW_OPS)
    return work.Work(nbytes, ops)
