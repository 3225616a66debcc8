"""raytpu_torch.io.checkpoint: checkpointed and resumed renders are
bit-identical to straight ones, mismatched settings fail loudly (the
cases of tests/test_checkpoint.py, on the port's plain path), and a
checkpoint written by either package resumes in the other: the same
fingerprint, the same npz. A render resumed in the port from raytpu's
checkpoint is held against raytpu's straight render under
tests/test_torch_render.py's rule (a pixel is an outlier past
1e-4 + 1e-5|x|, at most 2% of pixels may be).
"""

import dataclasses

import jax
import numpy as np
import pytest

from raytpu.io import checkpoint as jckpt
from raytpu.integrator.render import render_image as j_render_image
from raytpu.scenes import cornell_box as j_cornell_box
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core.rng import prng_key
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.integrator.render import render_image
from raytpu_torch.io import checkpoint as tckpt
from raytpu_torch.scenes import write_block_world

ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


def _arrays(tree, **static):
    d = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    d.update(static)
    return d


@pytest.fixture(scope="module")
def cornell():
    """raytpu's Cornell scene, and the port's copy of it (``convert``), at
    16x8, 8 spp, 3 bounces (tests/test_checkpoint.py's config)."""
    scene, cam, _ = j_cornell_box()
    cfg = TConfig(width=16, height=8, spp=8, max_bounces=3)
    tscene = convert.scene_from_arrays(
        _arrays(scene, sky_sphere_index=scene.sky_sphere_index), device="cpu")
    tcam = convert.camera_from_arrays(_arrays(cam), device="cpu")
    return (scene, cam), (tscene, tcam, cfg)


def _jcfg(cfg):
    from raytpu.core.types import RenderConfig

    return RenderConfig(**dataclasses.asdict(cfg))


def test_checkpointed_matches_straight(tmp_path, cornell):
    scene, cam, cfg = cornell[1]
    key = prng_key(11)
    straight = render_image(scene, cam, cfg, key)
    ck = tckpt.render_image_checkpointed(scene, cam, cfg, key,
                                         str(tmp_path / "r.npz"),
                                         flush_every=3)
    for a, b in zip(straight, ck):
        np.testing.assert_array_equal(a, b)
    z = np.load(tmp_path / "r.npz")
    assert sorted(z.files) == ["albedo", "normal", "radiance", "samples_done"]
    assert z["radiance"].shape == (cfg.n_pixels, 3)
    assert z["radiance"].dtype == np.float32
    assert z["samples_done"].dtype == np.int64 and int(z["samples_done"]) == 8


def test_resume_is_bit_identical(tmp_path, cornell):
    """A kill after 4 of 8 samples: the 4-spp run's sums, re-labelled as
    the 8-spp run's, resume to the straight 8-spp frame bit for bit; the
    tiles (pixel_tile 48 of 128 pixels, the last padded) do not matter."""
    scene, cam, cfg = cornell[1]
    key, path = prng_key(11), str(tmp_path / "r.npz")
    tckpt.render_image_checkpointed(scene, cam, cfg.replace(spp=4), key, path,
                                    flush_every=4)
    rad, alb, nrm, done = tckpt.load_checkpoint(path, cfg.replace(spp=4), 11)
    assert done == 4
    tckpt.save_checkpoint(path, rad, alb, nrm, done, cfg, 11)
    logs, seen = [], []
    resumed = tckpt.render_image_checkpointed(
        scene, cam, cfg.replace(pixel_tile=48), key, path, log=logs.append,
        progress=lambda n, sums: seen.append((n, sums.shape)))
    straight = render_image(scene, cam, cfg, key)
    for a, b in zip(straight, resumed):
        np.testing.assert_array_equal(a, b)
    assert logs[0] == f"resuming at 4/8 samples from {path}"
    assert seen == [(8, (cfg.n_pixels, 3))]


def test_mismatched_settings_fail(tmp_path, cornell):
    scene, cam, cfg = cornell[1]
    path = str(tmp_path / "r.npz")
    tckpt.render_image_checkpointed(scene, cam, cfg.replace(spp=2),
                                    prng_key(11), path)
    for other, key in ((cfg.replace(spp=2, max_bounces=4), prng_key(11)),
                       (cfg.replace(spp=2), prng_key(12))):
        with pytest.raises(ValueError, match="different settings"):
            tckpt.render_image_checkpointed(scene, cam, other, key, path)
    # a sidecar that predates a field matches while the run keeps its default
    assert tckpt.load_checkpoint(path, cfg.replace(spp=2), 11)[3] == 2
    # execution knobs do not count
    assert tckpt.load_checkpoint(path, cfg.replace(
        spp=2, pixel_tile=7, use_pallas=True, use_megakernel=True), 11)
    # no sidecar: no checkpoint
    (tmp_path / "r.npz.json").unlink()
    assert tckpt.load_checkpoint(path, cfg, 11) is None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)


def test_resume_with_quad_pairs(tmp_path, world):
    """tests/test_checkpoint.py's quad-pair resume on a generated block
    world (its pyramide_eau.toml is absent): tuple fields round-trip."""
    scene, cam, cfg = tconfig.load_scene_file(world, device="cpu")
    assert len(cfg.quad_pairs) > 0
    cfg = cfg.replace(width=12, height=8, spp=4, max_bounces=3)
    key, path = prng_key(3), str(tmp_path / "q.npz")
    tckpt.render_image_checkpointed(scene, cam, cfg.replace(spp=2), key, path,
                                    flush_every=2)
    rad, alb, nrm, done = tckpt.load_checkpoint(path, cfg.replace(spp=2), 3)
    assert done == 2
    tckpt.save_checkpoint(path, rad, alb, nrm, done, cfg, 3)
    resumed = tckpt.render_image_checkpointed(scene, cam, cfg, key, path)
    straight = render_image(scene, cam, cfg, key)
    np.testing.assert_array_equal(straight.image, resumed.image)
    with pytest.raises(ValueError, match="different settings"):
        tckpt.load_checkpoint(path, cfg.replace(quad_pairs=((0, 1, 0),)), 3)
    # with quad pairs the megakernel flag is part of the fingerprint
    with pytest.raises(ValueError, match="use_megakernel"):
        tckpt.load_checkpoint(path, cfg.replace(use_megakernel=True), 3)


def test_fingerprint_matches_raytpu(world):
    """The same dict in both packages: Cornell's config, and the merged
    block world's as raytpu loads it (quad pairs, use_megakernel kept)."""
    from raytpu.config import load_scene_file as j_load

    cases = [TConfig(width=16, height=8, spp=8, max_bounces=3),
             tconfig.load_scene_file(world, device="cpu")[2].replace(
                 use_megakernel=True)]
    jcfg = j_load(world)[2].replace(use_megakernel=True)
    assert tuple(map(tuple, jcfg.quad_pairs)) == tuple(cases[1].quad_pairs)
    for cfg, want_cfg in ((cases[0], _jcfg(cases[0])), (cases[1], jcfg)):
        got = tckpt._fingerprint(cfg, 7)
        assert got == jckpt._fingerprint(want_cfg, 7)
        assert ("use_megakernel" in got) == bool(cfg.quad_pairs)


def test_raytpu_checkpoint_resumes_in_port(tmp_path, cornell):
    """raytpu writes 4 of 8 samples; the port resumes to 8 and matches
    raytpu's straight 8-spp render."""
    (jscene, jcam), (scene, cam, cfg) = cornell
    jcfg, path = _jcfg(cfg), str(tmp_path / "j.npz")
    jkey = jax.random.PRNGKey(11)
    jckpt.render_image_checkpointed(jscene, jcam, jcfg.replace(spp=4), jkey,
                                    path, flush_every=4)
    rad, alb, nrm, done = jckpt.load_checkpoint(path, jcfg.replace(spp=4), 11)
    jckpt.save_checkpoint(path, rad, alb, nrm, done, jcfg, 11)

    resumed = tckpt.render_image_checkpointed(scene, cam, cfg, prng_key(11),
                                              path)
    want = j_render_image(jscene, jcam, jcfg, jkey)
    for name in ("image", "albedo", "normal"):
        x, y = np.asarray(getattr(want, name)), getattr(resumed, name)
        assert np.isfinite(y).all()
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, (name, bad.mean())
    assert int(np.load(path)["samples_done"]) == 8


def test_port_checkpoint_loads_in_raytpu(tmp_path, cornell):
    scene, cam, cfg = cornell[1]
    path = str(tmp_path / "t.npz")
    cfg = cfg.replace(spp=2)
    tckpt.render_image_checkpointed(scene, cam, cfg, prng_key(11), path)
    got = jckpt.load_checkpoint(path, _jcfg(cfg), 11)
    want = tckpt.load_checkpoint(path, cfg, 11)
    assert got[3] == want[3] == 2
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="different settings"):
        jckpt.load_checkpoint(path, _jcfg(cfg.replace(spp=3)), 11)
