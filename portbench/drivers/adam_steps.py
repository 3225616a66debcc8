"""Adam steps of ``train.inverse.make_train_step``, the loop ``cli train``
runs: each step renders the whole frame's pixel ids at the mix's samples
a step, takes the L2 loss against a target and updates every float leaf
of the scene.

The benchmark makes the inputs from the seed, on the card with a
``torch.Generator``: the start (the scene kind's ``training_start``: for
spheres the configuration's diffuse colours moved by up to ``perturb``
and clamped to [0, 1]) and the target, a linear image of squared uniform
draws. Step ``n`` renders with
``prng_key(seed + n)``. The loss is read every ``log_every`` steps, as
``--log-every`` does.

Set-up builds one step function and its Adam state and drives it through
its first ``check_steps`` steps, which warm every shape the window uses;
the window goes on with the same object. Each step is timed by a CUDA
event recorded after it, read once the window has closed, so timing
adds no sync; the mean step is the window's host seconds to the end of
its last step over its steps. The 95th percentile is of the steps' times
between those events (the card's clock, not the profiler's trace).

The check follows those first steps with the plain reference from the
same start, keys and target (``compare.train_numbers``): each step's
loss, the first gradient as Adam holds it (its first moment over 1 -
beta1) and each leaf's change over the checked steps.

``FAULTS``: faults planted in the timed path, for the tests that see
``correct`` come out false and for ``calibrate``'s readings of them;
each is a hook ``(run, key) -> loss`` that takes the step's place.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from portbench import compare, device
from portbench.reference import rng
from portbench.reference.train import ADAM_BETAS


class Run:
    def __init__(self, plan, seed: int, dev, fault=None):
        import torch

        from raytpu_torch.core.rng import prng_key
        from raytpu_torch.train import make_train_step

        self.torch, self.prng_key = torch, prng_key
        self.plan, self.seed, self.dev, self.fault = plan, seed, dev, fault
        self.mix = mix = plan.mix
        g = torch.Generator(device=dev)
        g.manual_seed(seed % 2**63)
        self.start = plan.scene.training_start(plan.config, g,
                                               mix["perturb"])
        scene, self.cam, cfg = plan.scene.program(self.start, dev)
        self.cfg = cfg.replace(spp=mix["spp"])
        n = self.cfg.n_pixels
        self.target = torch.rand((n, 3), generator=g, device=dev) ** 2
        self.pids = torch.arange(n, device=dev)
        init_fn, self.step_fn = make_train_step(self.cfg, mix["lr"])
        self.state, self.static = init_fn(scene, self.cam)
        self.attempted = self.failed = 0
        self.step = 0
        self.tr = None
        self.host_s, self.events, self.losses = [], [], []

    def _step(self):
        pids, target = self.pids, self.target
        key = self.prng_key(self.seed + self.step)
        if self.fault is not None:
            return self.fault(self, key)
        self.state, loss = self.step_fn(self.state, self.static, self.cam,
                                        pids, target, key)
        return loss

    def _leaves(self) -> dict:
        return {k: v.detach().clone() for k, v in self.state.params.items()}

    def setup(self, trace: bool) -> None:
        torch, b1 = self.torch, ADAM_BETAS[0]
        start = self._leaves()
        for n in range(self.mix["check_steps"]):
            self.losses.append(self._step())
            self.step += 1
            if n == 0:
                opt = self.state.optimizer
                self.grad1 = {
                    k: (opt.state[p]["exp_avg"] / (1 - b1)).cpu()
                    if p in opt.state else torch.zeros_like(p).cpu()
                    for k, p in self.state.params.items()}
        end = self._leaves()
        self.change = {k: (end[k] - start[k]).cpu() for k in start}
        self.losses = [float(x) for x in self.losses]
        if trace:
            self.tr = device.Trace(torch)
            self.tr.warm_up(self._warm_steps)

    def _warm_steps(self):
        for _ in range(2):
            self._step()
            self.step += 1

    def window(self, seconds: float) -> None:
        torch = self.torch
        cuda = self.dev.type == "cuda"
        n_trace = self.mix["trace_steps"] if self.tr else 0
        ev = lambda: torch.cuda.Event(enable_timing=True) if cuda else None
        self.t0 = t0 = time.perf_counter()
        self.t_traced = t0
        if self.tr:
            self.tr.start()
        start = ev()
        if cuda:
            start.record()
        self.events = [start]
        self.ends = []
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.attempted += 1
            h = time.perf_counter()
            if n < n_trace:
                with self.tr.span("portbench.step"):
                    loss = self._step()
            else:
                loss = self._step()
            self.host_s.append(time.perf_counter() - h)
            e = ev()
            if cuda:
                e.record()
            self.events.append(e)
            if n % self.mix["log_every"] == 0:
                float(loss)
            self.ends.append(time.perf_counter())
            self.step += 1
            n += 1
            if n == n_trace:
                self.tr.stop()
                self.t_traced = time.perf_counter()
                self.n_traced = n
                self.host_s.clear()
        if cuda:
            torch.cuda.synchronize(self.dev)
        self.t_end = time.perf_counter()
        if self.tr and n < n_trace:
            self.tr.stop()
            self.t_traced, self.n_traced = t0, n

    def release(self) -> None:
        del self.state, self.static
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def step_ms(self) -> np.ndarray:
        """Each window step's milliseconds: between the events recorded
        after it and after the step before (the window's start for the
        first); host seconds on the CPU."""
        if self.dev.type == "cuda":
            return np.array([a.elapsed_time(b) for a, b in
                             zip(self.events[:-1], self.events[1:])])
        ends = [self.t0, *self.ends]
        return np.diff(ends) * 1e3

    def end_to_end(self) -> dict:
        n = len(self.events) - 1
        return {"train_step_ms": (self.t_end - self.t0) / n * 1e3,
                "train_step_p95_ms": float(np.percentile(self.step_ms(), 95))}

    def describe_window(self) -> str:
        t = self.step_ms()
        return (f"{len(t)} steps, ms a step: min {t.min():.3f} median "
                f"{np.median(t):.3f} p95 {np.percentile(t, 95):.3f} max "
                f"{t.max():.3f}; host ms in the step call: median "
                f"{1e3 * np.median(self.host_s):.3f}")

    def reference_steps(self, dtype=None, counts=None):
        keys = [rng.key(0, self.seed + n, device=self.dev)
                for n in range(self.mix["check_steps"])]
        return self.plan.reference.train_steps(
            self.start, self.dev, keys, self.cfg.spp, self.target,
            self.mix["lr"], self.mix["ref_block_pixels"],
            dtype or self.torch.float32, counts)

    def check(self) -> dict:
        self.counts = {}
        self.ref = self.reference_steps(counts=self.counts)
        return compare.train_numbers(self.losses, self.grad1, self.change,
                                     *self.ref)

    def control(self, dtype) -> dict:
        """The check's numbers with the reference's steps computed in
        ``dtype`` in the program's place (after ``check``)."""
        return compare.train_numbers(*self.reference_steps(dtype), *self.ref)

    def reading(self) -> SimpleNamespace:
        r = self.tr.reduce()
        n_traced = self.n_traced
        steps = self.mix["check_steps"]
        rays = self.cfg.n_pixels * self.cfg.spp
        n_untraced = len(self.ends) - n_traced
        return SimpleNamespace(
            **r, units_traced=n_traced, samples_traced=n_traced * self.cfg.spp,
            work=self.plan.reference.layer_work(
                self.start, rays,
                {k: v / steps for k, v in self.counts.items()}, rays,
                train=True),
            host={"step_host_s": list(self.host_s)},
            untraced_units=n_untraced,
            untraced_s=(self.t_end - self.t_traced) if n_untraced else 0.0)


def state_unchanged(run, key):
    """A step that returns its state unchanged: the loss, no update."""
    import torch

    from raytpu_torch.integrator.render import render
    from raytpu_torch.train import combine_scene, photometric_loss

    with torch.no_grad():
        scene = combine_scene(run.state.params, run.static)
        sums = render(scene, run.cam, run.cfg, run.pids, key)
        return photometric_loss(sums.radiance * (1.0 / run.cfg.spp),
                                run.target)


def half_batch(run, key):
    """Half of the batch left out, the mean taken over the rest: the step
    sees every other pixel id."""
    run.state, loss = run.step_fn(run.state, run.static, run.cam,
                                  run.pids[::2].contiguous(),
                                  run.target[::2].contiguous(), key)
    return loss


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
