"""Back-to-back full frames through ``integrator.render.render_image``,
the call ``cli render`` makes: a closed loop with one client.

Each frame has its own key from the seed and renders the whole frame at
the configuration's sample count; it ends when its image is on the host.
Set-up renders one frame, which builds and loads the kernels and warms
every shape the window uses. The window starts frames until ``seconds``
have passed; the rate counts pixels x samples x bounces of every frame
over the seconds from the window's start to the end of the last frame.

The check: for every frame of the window, a sample of its pixels drawn
from the seed (``check_pixels`` of them) is traced by the plain reference
at the frame's full sample count, and the frame's image and canvas there
are compared (``compare.frame_numbers``).

Traced (``--trace 1``): the profiler covers the first ``trace_frames``
frames of the window (its warm-up frame runs in set-up), and a span
around ``render.assemble_image`` times the host's assembly of each
frame; the per-layer metrics read those, the work the reference counted
and, for the step's share of the peak, the frames after the profiled
ones.

``FAULTS``: faults planted in the timed path, for the tests that see
``correct`` come out false and for ``calibrate``'s readings of them;
each is a hook ``(run, frame, output) -> output``.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np

from portbench import compare, device
from portbench.reference import image, rng

MASK = 0xFFFFFFFF


def frame_key(seed: int, f: int) -> tuple[int, int]:
    """Frame ``f``'s key words under ``seed``; frame -1 has ``(0, seed)``,
    ``cli render --seed``'s key."""
    return ((((f + 1) * 0x9E3779B9) ^ (seed >> 32)) & MASK, seed & MASK)


def check_pixels(seed: int, f: int, n_pixels: int, n: int) -> np.ndarray:
    """The pixel ids of frame ``f`` that the check compares."""
    g = np.random.default_rng([seed % 2**64, f % 2**64])
    return np.sort(g.choice(n_pixels, size=min(n, n_pixels), replace=False))


class Run:
    def __init__(self, plan, seed: int, dev, fault=None):
        import torch

        from raytpu_torch.integrator import render

        self.torch, self.render = torch, render
        self.plan, self.seed, self.dev, self.fault = plan, seed, dev, fault
        self.mix = plan.mix
        self.scene, self.cam, self.cfg = plan.scene.program(plan.config, dev)
        self.attempted = self.failed = 0
        self.tr = None
        self.ends, self.answers = [], []
        self.assemble_s, self._unspan = [], []
        self.counts = {}

    def _frame(self, f: int):
        hi, lo = frame_key(self.seed, f)
        key = self.torch.tensor([hi, lo], dtype=self.torch.int64)
        out = self.render.render_image(self.scene, self.cam, self.cfg, key)
        return out if self.fault is None else self.fault(self, f, out)

    def setup(self, trace: bool) -> None:
        self._frame(-1)
        if trace:
            self.tr = device.Trace(self.torch)
            self.tr.warm_up(lambda: self._frame(-2))
            self._span_assemble()

    def _span_assemble(self) -> None:
        """Wraps ``render.assemble_image`` in a host span, under every name
        a module of the program holds it by."""
        orig = self.render.assemble_image

        def timed(*a, **k):
            t = time.perf_counter()
            out = orig(*a, **k)
            self.assemble_s.append(time.perf_counter() - t)
            return out

        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").split(".")[0] != "raytpu_torch":
                continue
            for name, v in list(vars(m).items()):
                if v is orig:
                    setattr(m, name, timed)
                    self._unspan.append((m, name, orig))

    def _keep(self, f: int, out) -> None:
        """The frame's answers at its checked pixels (image rows are
        top-down, pixel ids count rows from the bottom)."""
        w, h = self.cfg.width, self.cfg.height
        ids = check_pixels(self.seed, f, w * h, self.mix["check_pixels"])
        rows, cols = h - 1 - ids // w, ids % w
        self.answers.append((f, ids, np.array(out.image[rows, cols]),
                             np.array(out.canvas[rows, cols])))

    def window(self, seconds: float) -> None:
        n_trace = self.mix["trace_frames"] if self.tr else 0
        self.t0 = t0 = time.perf_counter()
        self.t_traced = t0
        if self.tr:
            self.tr.start()
        f = 0
        while True:
            self.attempted += 1
            if f < n_trace:
                with self.tr.span("portbench.frame"):
                    out = self._frame(f)
            else:
                out = self._frame(f)
            t = time.perf_counter()
            self.ends.append(t)
            self._keep(f, out)
            f += 1
            if f == n_trace:
                self.tr.stop()   # reads the events: not the frames' time
                self.t_traced = time.perf_counter()
                self.assemble_s.clear()
            if t - t0 >= seconds:
                break
        if self.tr and f < n_trace:
            self.tr.stop()
            self.t_traced = t0
        for m, name, orig in self._unspan:
            setattr(m, name, orig)

    def release(self) -> None:
        del self.scene, self.cam
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def end_to_end(self) -> dict:
        rays = self.cfg.n_pixels * self.cfg.spp * self.cfg.max_bounces
        return {"render_rays_per_s":
                len(self.ends) * rays / (self.ends[-1] - self.t0)}

    def describe_window(self) -> str:
        t = np.diff([self.t0, *self.ends])
        return (f"{len(t)} frames, s a frame: min {t.min():.4f} median "
                f"{np.median(t):.4f} max {t.max():.4f}")

    def reference_answers(self, dtype=None, counts=None):
        """(image, canvas) of the plain reference at every frame's checked
        pixels, traced in ``dtype`` (float32 by default)."""
        torch, ref = self.torch, self.plan.reference
        built = ref.build(self.plan.config, self.dev)
        imgs, canvases = [], []
        for f, ids, _, _ in self.answers:
            k = rng.key(*frame_key(self.seed, f), device=self.dev)
            sums = ref.render_pixels(
                *built, k, torch.as_tensor(ids, device=self.dev),
                self.cfg.spp, dtype or torch.float32,
                self.mix["ref_max_rays"], counts)
            mean, canvas = image.pixels(sums.T.cpu().numpy(), self.cfg.spp)
            imgs.append(mean)
            canvases.append(canvas)
        return np.concatenate(imgs), np.concatenate(canvases)

    def program_answers(self):
        return (np.concatenate([a[2] for a in self.answers]),
                np.concatenate([a[3] for a in self.answers]))

    def check(self) -> dict:
        self.counts = {}
        self.ref = self.reference_answers(counts=self.counts)
        return compare.frame_numbers(*self.program_answers(), *self.ref)

    def control(self, dtype) -> dict:
        """The check's numbers with the reference traced in ``dtype`` in
        the program's place (after ``check``)."""
        return compare.frame_numbers(*self.reference_answers(dtype),
                                     *self.ref)

    def reading(self) -> SimpleNamespace:
        """What the per-layer metrics read (``readers``)."""
        r = self.tr.reduce()
        n_traced = min(self.mix["trace_frames"], len(self.ends))
        counted = sum(len(a[1]) for a in self.answers) * self.cfg.spp
        rays = self.cfg.n_pixels * self.cfg.spp
        n_untraced = len(self.ends) - n_traced
        return SimpleNamespace(
            **r, units_traced=n_traced, samples_traced=n_traced * self.cfg.spp,
            work=self.plan.reference.layer_work(self.plan.config, rays,
                                                self.counts, counted),
            host={"assemble_s": list(self.assemble_s)},
            untraced_units=n_untraced,
            untraced_s=(self.ends[-1] - self.t_traced) if n_untraced else 0.0)


def answer_altered(run, f, out):
    """An answer altered where it is produced: the frame's radiance off by
    a thousandth."""
    return out._replace(image=out.image * 1.001)


def half_batch(run, f, out):
    """Half of the batch left out: every other pixel id of the frame
    never rendered (zero)."""
    img, canvas = out.image.copy(), out.canvas.copy()
    h, w = run.cfg.height, run.cfg.width
    ids = np.arange(1, h * w, 2)
    rows, cols = h - 1 - ids // w, ids % w   # image rows are top-down
    img[rows, cols] = 0.0
    canvas[rows, cols] = 0
    return out._replace(image=img, canvas=canvas)


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch}
