"""The system under test, driven the way a user drives it: the port's
public constructors take the run's inputs, and `train.fit` trains them.

`fit` is one call for the whole run. Its chunk-boundary callback
(`callback_every` = CHUNK, with `log_every` 100, so `fit` replays one
step's CUDA graph CHUNK times a chunk, as at its defaults) marks the run's
phases: the first chunk's state and last step are kept for the check of
`correct`; the warm-up ends at the callback after `warm_steps` steps (every
capture, re-tune and overflow replay of the first chunks falls before it);
the window then runs until the first callback at least `seconds` later,
and `fit` is stopped there by an exception from the callback. The callback
adds one `torch.cuda.synchronize()` a chunk, after `fit`'s own read of the
chunk's overflow flag has already waited for the device.

With `trace`, the window is instead `trace_chunks` whole chunks under
`torch.profiler` (`benchmark/trace.py`), and `fit` stops after them.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, GaussianScene

from benchmark import inputs as binputs

CHUNK = 50
LOG_EVERY = 100


class _Stop(Exception):
    """Ends `fit` at a chunk boundary once the window has closed."""


def optim_params(config: dict) -> OptimizationParams:
    return OptimizationParams(**config["optimization"])


def fit_config(config: dict, rng: int) -> Config:
    return Config(renderer=config["renderer"], start=config["start"], end=config["end"],
                  num_sampling_points=config["num_sampling_points"],
                  sh_degree=config["sh_degree"], batch_size=config["batch_size"],
                  space_carving_init=False, print_interval=LOG_EVERY, rng=rng)


def nlos_data(config: dict, inp: dict) -> NLOSData:
    m, n = config["scan_grid"]
    return NLOSData(
        nlos_data=inp["targets"], camera_position=np.array([0.0, -1.0, 0.0], np.float32),
        camera_grid_size=np.array([0.8, 0.8], np.float32),
        camera_grid_positions=inp["grid"], camera_grid_points=np.array([m, n], np.int32),
        volume_position=np.array(binputs.VOLUME_POSITION, np.float32),
        volume_size=binputs.VOLUME_SIZE, deltaT=binputs.DELTA_T, c=binputs.C_LIGHT)


def train_state(config: dict, inp: dict) -> train.TrainState:
    """The port's state from the inputs: the scene's fields, Adam's moments
    (the six groups in the port's order), its count, the step counter and
    the active SH degree."""
    p = inp["params"]
    scene = GaussianScene(*(p[name].clone() for name in FIELD_NAMES))
    state = train.create_train_state(scene, optim_params(config))
    port_of = dict(zip(train.GROUPS, ("means", "sh_dc", "sh_rest", "logit_opacities",
                                      "log_scales", "quats")))
    with torch.no_grad():
        for i, g in enumerate(train.GROUPS):
            state.opt_state.mu[i].copy_(inp["mu"][port_of[g]])
            state.opt_state.nu[i].copy_(inp["nu"][port_of[g]])
        state.opt_state.count.fill_(inp["count"])
        state.step.fill_(inp["step"])
        state.active_sh_degree.fill_(inp["sh_degree"])
    return state


def state_dict(state: train.TrainState) -> dict:
    """The reference's view of a port state: the scene's fields and Adam's
    moments by field name, and the count."""
    field_of = dict(zip(train.GROUPS, ("means", "sh_dc", "sh_rest", "logit_opacities",
                                       "log_scales", "quats")))
    o = state.opt_state
    return dict(params={n: getattr(state.scene, n).detach() for n in FIELD_NAMES},
                mu={field_of[g]: m.detach() for g, m in zip(train.GROUPS, o.mu)},
                nu={field_of[g]: v.detach() for g, v in zip(train.GROUPS, o.nu)},
                count=int(o.count))


@torch.no_grad()
def population_summary(state) -> dict:
    """The alive population's size, mean log-scale and mean opacity: how far
    training has moved the cell's population (logged beside the window)."""
    sc = state.scene
    alive = sc.alive > 0.5
    return dict(alive=int(alive.sum()), mean_log_scale=float(sc.log_scales[alive].mean()),
                mean_opacity=float(torch.sigmoid(sc.logit_opacities[alive]).mean()))


class Run:
    """One `fit` call and what its callback saw (the module docstring).

    After `run()`: `first` (the state dict and (loss, pred_hist,
    target_hist) after the first chunk) and `t_first` (its host time),
    `t0`/`t1` and `steps0`/`steps1` (the window's bounds), `traced` (the
    profiler's trace), `trace_state` (the state as the traced window
    began) and `population` (`population_summary` at the window's ends)."""

    def __init__(self, config: dict, inp: dict, warm_steps: int, seconds: float,
                 trace: bool = False, trace_chunks: int = 2, profiler=None,
                 max_steps: int = 200_000):
        self.config, self.inp = config, inp
        self.warm, self.seconds = warm_steps, seconds
        self.trace, self.trace_chunks, self.profiler = trace, trace_chunks, profiler
        self.num_iters = max_steps
        self.first = None
        self.t0 = self.t1 = self.steps0 = self.steps1 = None
        self.trace_state = None
        self.traced = None
        self.population = []
        self.t_first = None
        self.dev = inp["targets"].device

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def callback(self, it: int, state, aux) -> None:
        done = it + 1
        now = self._sync()
        if done == CHUNK:
            self.t_first = now
            self.first = (state_dict(state), (aux.loss.detach(), aux.pred_hist.detach(),
                                              aux.target_hist.detach()))
        if self.t0 is None:
            if done >= self.warm:
                self.population = [population_summary(state)]
                now = self._sync()
                self.t0, self.steps0 = now, done
                if self.trace:
                    self.trace_state = state_dict(state)
                    self.profiler.start()
                    self.t0 = self._sync()
            return
        if self.trace:
            if done >= self.steps0 + self.trace_chunks * CHUNK:
                self.traced = self.profiler.stop()
                self.t1, self.steps1 = self._sync(), done
                self.population.append(population_summary(state))
                raise _Stop
            return
        if now - self.t0 >= self.seconds:
            self.t1, self.steps1 = now, done
            self.population.append(population_summary(state))
            raise _Stop

    def run(self) -> "Run":
        cfg = fit_config(self.config, self.inp["rng"])
        optim = optim_params(self.config)
        data = nlos_data(self.config, self.inp)
        state = train_state(self.config, self.inp)
        # The port prints its re-tunes to stdout; the run's stdout is its
        # result line alone.
        with contextlib.redirect_stdout(sys.stderr):
            try:
                train.fit(cfg, optim, data, num_iters=self.num_iters, log_every=LOG_EVERY,
                          callback=self.callback, init_state=state, callback_every=CHUNK,
                          device=self.dev)
            except _Stop:
                pass
        return self


def render_settings(config: dict, scene, probes, cams):
    """The backend's settings with capacities fitted to `scene` on the
    probes and `cams` (as `fit`'s re-tune fits them)."""
    from nlos_gaussian_renderer_tpu_torch.ops.math import volume_box_points
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    settings = RenderSettings.from_config(fit_config(config, 0))
    box = volume_box_points(binputs.VOLUME_POSITION, binputs.VOLUME_SIZE, device=cams.device)
    pts = np.concatenate([probes, cams.detach().cpu().numpy()])
    with contextlib.redirect_stdout(sys.stderr):
        settings, _ = train.fit_culling_capacity(settings, scene, pts, box, binputs.C_LIGHT,
                                                 binputs.DELTA_T, grow_only=False)
    return settings, box


def eager_steps(config: dict, state_d: dict, cams, targets, steps: int, profiler=None):
    """`steps` train steps of the port's step function run eagerly (not from
    a graph) from a copy of `state_d`, the first one outside `profiler`:
    what the trace's eager twin profiles."""
    inp = dict(params=state_d["params"], mu=state_d["mu"], nu=state_d["nu"],
               count=state_d["count"], step=state_d["count"] + 1,
               sh_degree=config["sh_degree"])
    state = train_state(config, inp)
    m, n = config["scan_grid"]
    probes = binputs.probe_points(binputs.make_scan_grid(m, n), m, n)
    settings, box = render_settings(config, state.scene, probes, cams)
    step = train.make_train_step(settings, optim_params(config), config["sh_degree"])
    vol = torch.as_tensor(binputs.VOLUME_POSITION, device=cams.device)
    consts = (box, binputs.C_LIGHT, binputs.DELTA_T, vol)
    step(state, cams[:1], targets[:1], *consts)
    if profiler is not None:
        profiler.start()
    for i in range(1, steps + 1):
        step(state, cams[i:i + 1], targets[i:i + 1], *consts)
    return profiler.stop() if profiler is not None else None
