"""raytpu_torch.denoise against raytpu.denoise on the same inputs.

The joint bilateral (values and gradients against ``jax.grad``), the
KPCN on the shipped weights, the weight files written and read by each
package, and PSNR / SSIM, on seeded images made with numpy (24x20,
colors in [0, 3)). Tolerances: bilateral 1e-5 + 1e-5|x|, its gradients
1e-4 relative; KPCN 1e-5 absolute; PSNR 1e-4 dB, SSIM 1e-6.
"""

import filecmp
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.denoise import DenoiseParams as JParams
from raytpu.denoise import denoise as j_denoise
from raytpu.denoise import learned as jlearned
from raytpu.denoise import quality as jquality
from raytpu_torch.denoise import DenoiseParams as TParams
from raytpu_torch.denoise import denoise as t_denoise
from raytpu_torch.denoise import learned as tlearned
from raytpu_torch.denoise import quality as tquality

H, W = 20, 24


def _images(seed=0, h=H, w=W):
    """(color, albedo, normal) float32 (H, W, 3): colors in [0, 3), a few
    below 0, albedo in [0, 1), unit normals."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32)
    color[0, :3] = -0.25                      # log1p(max(c, 0)) clamps these
    albedo = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    n = rng.normal(size=(h, w, 3))
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return color, albedo, normal


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


SIGMAS = {"default": None,
          "tiny": dict(sigma_spatial=0.5, sigma_albedo=0.01,
                       sigma_normal=0.02, sigma_color=0.05, radius=2)}


@pytest.mark.parametrize("which", sorted(SIGMAS))
def test_bilateral_matches_raytpu(which):
    imgs = _images()
    kw = SIGMAS[which]
    jp = None if kw is None else JParams.default(**kw)
    tp = None if kw is None else TParams.default(**kw, device="cpu")
    want = np.asarray(jax.jit(j_denoise)(*_j(*imgs), jp))
    got = t_denoise(*_t(*imgs), tp).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kw is None:       # the tiny sigmas leave random pixels as they are
        assert np.abs(got - imgs[0]).max() > 1e-2


def test_bilateral_default_params():
    """``DenoiseParams.default`` holds raytpu's four sigmas as 0-dim f32
    tensors and radius 3."""
    jp, tp = JParams.default(), TParams.default(device="cpu")
    for f in ("sigma_spatial", "sigma_albedo", "sigma_normal", "sigma_color"):
        v = getattr(tp, f)
        assert v.shape == () and v.dtype == torch.float32
        assert v.item() == float(getattr(jp, f))
    assert tp.radius == jp.radius == 3


def test_bilateral_grads_match_jax():
    """d(sum(out * g)) / d(color, four sigmas) against jax.grad, over a
    5x5 window."""
    color, albedo, normal = _images(1)
    g = np.random.default_rng(2).normal(size=color.shape).astype(np.float32)
    sig = (1.5, 0.3, 0.4, 0.8)

    def j_loss(c, s):
        p = JParams(*s, radius=2)
        return jnp.sum(j_denoise(c, jnp.asarray(albedo), jnp.asarray(normal),
                                 p) * g)

    jg_c, jg_s = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(color), tuple(jnp.float32(s) for s in sig))

    c = torch.from_numpy(color).requires_grad_()
    s = [torch.tensor(v, requires_grad=True) for v in sig]
    out = t_denoise(c, *_t(albedo, normal), TParams(*s, radius=2))
    (out * torch.from_numpy(g)).sum().backward()

    want_c = np.asarray(jg_c)
    assert np.abs(c.grad.numpy() - want_c).max() <= 1e-4 * np.abs(want_c).max()
    for got, want in zip(s, jg_s):
        assert abs(got.grad.item() - float(want)) <= 1e-4 * abs(float(want))
        assert float(want) != 0.0


@pytest.fixture(scope="module")
def j_kpcn():
    """raytpu's KPCN on its shipped weights, jitted (its load_params
    initialises a flax model, seconds on the CPU: once a module)."""
    params = jlearned.load_params()
    fn = jax.jit(jlearned.denoise_learned)
    return lambda c, a, n: fn(c, a, n, params)


def test_kpcn_matches_raytpu(j_kpcn):
    imgs = _images()
    want = np.asarray(j_kpcn(*_j(*imgs)))
    with torch.no_grad():
        got = tlearned.denoise_learned(*_t(*imgs)).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5


def test_kpcn_weights_are_raytpus():
    """The port's weights file is a byte-identical copy of raytpu's, and
    loads into OIHW kernels."""
    assert filecmp.cmp(tlearned.WEIGHTS_PATH, jlearned.WEIGHTS_PATH,
                       shallow=False)
    assert os.path.getsize(tlearned.WEIGHTS_PATH) == 107659
    z = np.load(tlearned.WEIGHTS_PATH)
    assert len(z.files) == 10
    model = tlearned.load_params(device="cpu")
    hwio = z["['params']['Conv_0']['kernel']"]
    np.testing.assert_array_equal(model.convs[0].weight.detach().numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    assert model.convs[4].weight.shape == (49, 24, 3, 3)


def test_save_params_loads_in_raytpu(tmp_path):
    """A file the port's save_params writes loads in raytpu's load_params
    (and back in the port's) and gives the same output."""
    path = str(tmp_path / "kpcn.npz")
    model = tlearned.init_params(torch.Generator().manual_seed(5),
                                 device="cpu")
    tlearned.save_params(model, path)
    imgs = _images(3)
    jparams = jlearned.load_params(path)
    want = np.asarray(jax.jit(jlearned.denoise_learned)(*_j(*imgs),
                                                        jparams))
    with torch.no_grad():
        got = tlearned.denoise_learned(*_t(*imgs), params=model).numpy()
    assert np.abs(got - want).max() <= 1e-5
    again = tlearned.load_params(path, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    # flax's initialisers: kernels within 2 LeCun sigmas, biases zero
    w0 = model.convs[0].weight
    assert w0.abs().max().item() <= 2 * (1 / 81) ** 0.5 / 0.8796256610342398
    assert all(not c.bias.any() for c in model.convs)


def test_load_params_rejects_bad_files(tmp_path, monkeypatch):
    z = dict(np.load(tlearned.WEIGHTS_PATH))
    missing = str(tmp_path / "missing.npz")
    np.savez(missing, **{k: v for k, v in z.items()
                         if k != "['params']['Conv_2']['bias']"})
    with pytest.raises(ValueError, match="missing"):
        tlearned.load_params(missing, device="cpu")
    wrong = str(tmp_path / "wrong.npz")
    z["['params']['Conv_1']['kernel']"] = np.zeros((3, 3, 24, 23), np.float32)
    np.savez(wrong, **z)
    with pytest.raises(ValueError, match="shape"):
        tlearned.load_params(wrong, device="cpu")
    absent = str(tmp_path / "absent.npz")
    assert tlearned.load_params(absent, device="cpu") is None
    monkeypatch.setattr(tlearned, "WEIGHTS_PATH", absent)
    with pytest.raises(FileNotFoundError):
        tlearned.denoise_learned(*_t(*_images()))


def test_psnr_ssim_match_raytpu():
    a, b, _ = _images(4)
    b = np.clip(a + np.random.default_rng(5).normal(0, 0.2, a.shape),
                0, 3).astype(np.float32)
    for tonemap in (True, False):
        x, y = (a / 3, b / 3) if not tonemap else (a, b)
        jp = jquality.psnr(jnp.asarray(x), jnp.asarray(y), tonemap=tonemap)
        tp = tquality.psnr(*_t(x, y), tonemap=tonemap)
        assert abs(tp - jp) <= 1e-4, (tp, jp)
        js = jquality.ssim(jnp.asarray(x), jnp.asarray(y), tonemap=tonemap)
        ts = tquality.ssim(*_t(x, y), tonemap=tonemap)
        assert abs(ts - js) <= 1e-6, (ts, js)
    img = torch.from_numpy(a)
    assert tquality.psnr(img, img) > 100.0
    assert abs(tquality.ssim(img, img) - 1.0) < 1e-5


class _Out(NamedTuple):
    image: np.ndarray
    albedo: np.ndarray
    normal: np.ndarray


def test_score_denoisers_matches_raytpu(j_kpcn):
    """The noisy baseline, a fixed image and both denoisers, scored
    against a target by each package's score_denoisers on the same
    (top-down view) arrays. The scores of the same images agree to PSNR's
    and SSIM's bounds; the denoisers' own outputs differ by up to their
    1e-5, which moves their scores by up to ~1e-5."""
    color, albedo, normal = _images(6)
    target = np.clip(color * 0.5 + 0.2, 0, None).astype(np.float32)
    fixed = np.clip(color * 0.6 + 0.1, 0, None).astype(np.float32)
    flip = lambda a: a[::-1]          # render_image's images are views so
    lo = _Out(flip(color), flip(albedo), flip(normal))
    hi = _Out(flip(target), flip(albedo), flip(normal))
    want = jquality.score_denoisers(lo, hi, {
        "fixed": lambda c, a, n: jnp.asarray(fixed),
        "bilateral": jax.jit(j_denoise), "learned": j_kpcn})
    got = tquality.score_denoisers(lo, hi, {
        "fixed": lambda c, a, n: torch.from_numpy(fixed),
        "bilateral": t_denoise, "learned": tlearned.denoise_learned},
        device="cpu")
    assert sorted(got) == ["bilateral", "fixed", "learned", "noisy"]
    for name, (d_psnr, d_ssim) in {"noisy": (1e-4, 1e-6),
                                   "fixed": (1e-4, 1e-6),
                                   "bilateral": (1e-3, 1e-5),
                                   "learned": (1e-3, 1e-5)}.items():
        assert abs(got[name]["psnr"] - want[name]["psnr"]) <= d_psnr
        assert abs(got[name]["ssim"] - want[name]["ssim"]) <= d_ssim
