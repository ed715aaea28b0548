"""Training: optimizer, train step, K-step chunk and the fit loop (PyTorch).

Port of `nlos_gaussian_renderer_tpu/train.py`:
  - Adam over six parameter groups with per-group learning rates, eps
    1e-15, in optax's formula (`Adam`); the position group follows the
    log-linear decay, evaluated on the device at the 0-based update count;
  - one (or a batch of) confocal scan point(s) per step, MSE against the
    target histogram, optional alive-masked |opacity| / |scale| regularizers;
  - SH-degree annealing every `sh_anneal_interval` steps, a device `where`;
  - `make_train_step`: one step that applies the update, adds the SGLD
    position noise (`sgld_position_noise`) when asked, and returns its
    overflow flag on the device. It reads nothing back to the host, so it
    can be captured in a CUDA graph;
  - `make_scanned_train_step`: K steps over device-resident cameras and
    targets. On the card one step is captured into a CUDA graph and
    replayed K times (JAX's `lax.scan` chunk: no host read inside the
    chunk), and with `densify_seed` one `densify_step` into a second graph,
    replayed after the steps whose post-update counter densifies; with
    `ref_cam` (frozen layouts, the rsort family) the chunk's block layout
    is built from the entering state by a third graph, replayed once before
    the steps, which then sort nothing; on the CPU the same calls run in a
    loop;
  - `fit_culling_capacity`: the kernel backends' static capacities fitted
    to a scene on probe scan points;
  - `prepare_training` and `fit`, the training entry point: the scan-point
    order from `cfg.rng`, the chunk and the log and callback cadences, and
    the overflow gate (`OverflowGate`): a chunk or log window whose render
    overflowed a capacity is re-tuned and replayed from its starting state;
    MCMC densification (`models/densify.py`) at `densify_fires`'s counters,
    each followed by a re-tune.

PyTorch updates in place where JAX returns a new state, so the state to
replay from is a device-to-device snapshot (`snapshot_state`): the port's
counterpart of JAX's `donate=False`. The SGLD noise and the donor draws
are keyed on `(seed, step)` with the step read from its device tensor
(`ops/random.py`), so a replay draws what the first run drew.
`cfg.frozen_layout` trains the rsort family's chunks on one layout each,
from `layout_reference(data)` ('pallas_dsort' takes no layout, as in JAX);
per_gaussian occlusion renders in Gaussian chunks on every backend but
'dense'. With `gauss_group`, `batched_loss_fn` renders a Gaussian shard
(`parallel/sharding.py` builds the sharded steps on it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.models.scene import (
    FIELD_NAMES,
    GaussianScene,
    init_scene,
    scene_param_labels,
)
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops import random as prng
from nlos_gaussian_renderer_tpu_torch.ops.fused_dsort import tune_dsort_spec
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import rsort_layout, tune_rsort_spec
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    KERNEL_BACKENDS,
    RSORT_FAMILY,
    RenderSettings,
    check_culling_capacity,
    gauss_sum,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.ops.schedule import expon_lr_schedule_tensor

# The six Adam groups in optax's label order, and each group's scene field.
GROUPS = ("mu", "f_dc", "f_rest", "opacity", "scaling", "rotation")
GROUP_FIELD = {label: field for field, label in scene_param_labels().items()
               if label in GROUPS}
# The SGLD normals' first hash lane: apart from the donor draws' lanes 0-3.
SGLD_LANE0 = 16
# The backends whose work-list capacities live in `rsort_spec` (w_max and,
# re-tuned and force-grown as JAX's, max_groups).
RSPEC_BACKENDS = RSORT_FAMILY + ("pallas_dsort",)


# --- optimizer -------------------------------------------------------------------


class Adam:
    """Six Adam groups matching `GaussianModel.training_setup`, in optax's
    formula (`optax.adam(lr, b1=0.9, b2=0.999, eps=1e-15)` per group, the
    alive mask frozen): m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v,
    p += -lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), t the
    update count. The position group's lr is the log-linear decay at the
    count before the update, computed on the device. Tensor ops only (the
    moments with `torch._foreach_*`): one code on the CPU, eagerly on the
    card and inside a CUDA graph."""

    b1, b2, eps = 0.9, 0.999, 1e-15

    def __init__(self, optim: OptimizationParams, spatial_lr_scale: float = 1.0):
        self.mu_schedule = expon_lr_schedule_tensor(
            lr_init=optim.position_lr_init * spatial_lr_scale,
            lr_final=optim.position_lr_final * spatial_lr_scale,
            lr_delay_mult=optim.position_lr_delay_mult,
            max_steps=optim.position_lr_max_steps,
        )
        self.lrs = {
            "f_dc": optim.feature_lr,
            "f_rest": optim.feature_lr / 20.0,
            "opacity": optim.opacity_lr,
            "scaling": optim.scaling_lr,
            "rotation": optim.rotation_lr,
        }

    def init(self, scene: GaussianScene) -> "AdamState":
        params = group_params(scene)
        return AdamState(
            tx=self,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            count=torch.zeros((), dtype=torch.int32, device=scene.means.device),
        )

    @torch.no_grad()
    def update(self, state: "AdamState", params, grads) -> None:
        """One update of `params` (GROUPS order) and `state`, in place."""
        b1, b2 = self.b1, self.b2
        lr_mu = self.mu_schedule(state.count)
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                         1 - b2))
        state.count.add_(1)
        t = state.count.to(params[0].dtype)
        upd = torch._foreach_div(state.mu, 1 - torch.pow(b1, t))
        den = torch._foreach_div(state.nu, 1 - torch.pow(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        upd[0].mul_(-lr_mu.to(params[0].dtype))  # GROUPS[0] is the position group
        torch._foreach_mul_(upd[1:], [-self.lrs[g] for g in GROUPS[1:]])
        torch._foreach_add_(params, upd)


@dataclasses.dataclass
class AdamState:
    tx: Adam
    mu: list  # first moments, GROUPS order
    nu: list  # second moments
    count: torch.Tensor  # () int32 updates so far (optax's count)


def make_optimizer(optim: OptimizationParams, spatial_lr_scale: float = 1.0) -> Adam:
    return Adam(optim, spatial_lr_scale)


def group_params(scene: GaussianScene) -> list:
    return [getattr(scene, GROUP_FIELD[g]) for g in GROUPS]


@dataclasses.dataclass
class TrainState:
    scene: GaussianScene
    opt_state: AdamState
    step: torch.Tensor  # () int32, 1-based like the reference
    active_sh_degree: torch.Tensor  # () int32


def create_train_state(scene: GaussianScene, tx, spatial_lr_scale: float = 1.0
                       ) -> TrainState:
    """The state at step 1; `tx` is an `Adam` or the `OptimizationParams`
    to build one from."""
    if not isinstance(tx, Adam):
        tx = make_optimizer(tx, spatial_lr_scale)
    dev = scene.means.device
    return TrainState(
        scene=scene,
        opt_state=tx.init(scene),
        step=torch.ones((), dtype=torch.int32, device=dev),
        active_sh_degree=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_tensors(state: TrainState) -> list:
    """Every tensor a step or a densify step updates: parameters, the alive
    mask, moments and counters."""
    o = state.opt_state
    return (group_params(state.scene) + [state.scene.alive] + o.mu + o.nu
            + [o.count, state.step, state.active_sh_degree])


def clone_state(state: TrainState) -> TrainState:
    """A detached copy of the state in tensors of its own (one state's
    memory): `fit` trains a copy of its `init_state` and hands each
    callback one, as JAX's undonated `fit` leaves its input as it was."""
    with torch.no_grad():
        sc, o = state.scene, state.opt_state
        return TrainState(
            scene=GaussianScene(*(getattr(sc, n).detach().clone() for n in FIELD_NAMES)),
            opt_state=AdamState(tx=o.tx, mu=[m.clone() for m in o.mu],
                                nu=[v.clone() for v in o.nu], count=o.count.clone()),
            step=state.step.clone(),
            active_sh_degree=state.active_sh_degree.clone(),
        )


def snapshot_state(state: TrainState) -> list:
    """A device-to-device copy of `state_tensors` to replay from."""
    with torch.no_grad():
        return [t.detach().clone() for t in state_tensors(state)]


def restore_state(state: TrainState, snap: list) -> None:
    """Copy a snapshot back into the state's own tensors (their storage
    stays, so a captured graph keeps reading and writing them)."""
    with torch.no_grad():
        for t, s in zip(state_tensors(state), snap):
            t.copy_(s)


def train_state_to_numpy(state: TrainState) -> dict:
    """{'scene': {field: array}, 'mu', 'nu': {group: array}, 'count',
    'step', 'active_sh_degree': int}: the state as host arrays, in the form
    `train_state_from_numpy` takes."""
    o = state.opt_state

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "scene": {n: host(getattr(state.scene, n)) for n in FIELD_NAMES},
        "mu": {g: host(m) for g, m in zip(GROUPS, o.mu)},
        "nu": {g: host(v) for g, v in zip(GROUPS, o.nu)},
        "count": int(o.count),
        "step": int(state.step),
        "active_sh_degree": int(state.active_sh_degree),
    }


def train_state_from_numpy(d: dict, tx, device=None) -> TrainState:
    """A state from host arrays (`train_state_to_numpy`'s form): e.g. a JAX
    `TrainState` whose scene, optax moments and counts per group were
    converted with `np.asarray`, so both packages step from one state.
    'count' is one int or {group: int}; the groups' counts must agree. The
    arrays keep their float dtype; `tx` as for `create_train_state`."""
    dev = gmath.default_device(device)
    if not isinstance(tx, Adam):
        tx = make_optimizer(tx)
    scene = GaussianScene(*(torch.as_tensor(np.array(d["scene"][n]), device=dev)
                            for n in FIELD_NAMES))
    counts = d["count"]
    if isinstance(counts, dict):
        if len(set(int(v) for v in counts.values())) != 1:
            raise ValueError(f"the groups' update counts differ: {counts}")
        counts = next(iter(counts.values()))

    def i32(v):
        return torch.full((), int(v), dtype=torch.int32, device=dev)

    def moments(key):
        return [torch.as_tensor(np.array(d[key][g]), device=dev) for g in GROUPS]

    return TrainState(
        scene=scene,
        opt_state=AdamState(tx=tx, mu=moments("mu"), nu=moments("nu"), count=i32(counts)),
        step=i32(d["step"]),
        active_sh_degree=i32(d["active_sh_degree"]),
    )


# --- the step --------------------------------------------------------------------


class StepAux(NamedTuple):
    loss: torch.Tensor
    equal_loss: torch.Tensor
    pred_hist: torch.Tensor  # (B, num_r)
    target_hist: torch.Tensor
    # True when a kernel backend's capacity saturated during this step's
    # render (a device bool): contributions were dropped and `fit` replays.
    overflow: torch.Tensor


def batched_loss_fn(scene: GaussianScene, cams, targets, box_points, c,
                    delta_t, volume_position, active_sh_degree,
                    settings: RenderSettings, optim: OptimizationParams,
                    layout=None, gauss_group=None):
    """Mean MSE over the (B, 3) scan points (one render each) plus the
    alive-masked regularizers; every render through `layout` (a frozen
    rsort layout) when given. With `gauss_group` the scene is this rank's
    Gaussian shard: the renders and the regularizers' sums are summed over
    the group (JAX's `gauss_axis`). Returns (loss, StepAux)."""
    losses, eqs, hists, overflows = [], [], [], []
    for cam, target in zip(cams, targets):
        _, hist, overflow = render_transient(
            scene, cam, box_points, c, delta_t, volume_position,
            active_sh_degree, settings, layout=layout, gauss_group=gauss_group,
        )
        loss, eq = mse_loss(hist, target)
        losses.append(loss)
        eqs.append(eq)
        hists.append(hist)
        overflows.append(overflow)
    loss = torch.stack(losses).mean()

    if optim.regularization:
        n_alive, op_sum, sc_sum = gauss_sum(torch.stack([
            scene.num_alive, torch.sum(torch.abs(scene.opacities)),
            torch.sum(torch.abs(scene.scales) * scene.alive[:, None])]), gauss_group)
        n_alive = torch.clamp(n_alive, min=1.0)
        loss = (
            loss
            + optim.opacity_reg * op_sum / n_alive
            + optim.scale_reg * sc_sum / (3.0 * n_alive)
        )
    return loss, StepAux(
        loss=loss.detach(),
        equal_loss=torch.stack(eqs).mean().detach(),
        pred_hist=torch.stack(hists).detach(),
        target_hist=targets,
        overflow=torch.stack(overflows).any(),
    )


def sgld_position_noise(scene: GaussianScene, eps: torch.Tensor, lr: torch.Tensor,
                        optim: OptimizationParams) -> torch.Tensor:
    """Covariance-shaped exploration noise for the Gaussian positions (the
    stochastic term of MCMC-GS, JAX `train.sgld_position_noise`): per
    Gaussian lr * noise_lr * gate(opacity) * alive * (R S eps), gate a sharp
    reverse sigmoid around the dead-opacity knee, so low-opacity Gaussians
    random-walk while confident ones stay put. `eps` (N, 3) standard
    normals, `lr` a 0-d tensor."""
    rot = gmath.quat_to_rotmat(scene.rotations)  # (N, 3, 3)
    s_eps = scene.scales * eps  # diag(S) eps
    shaped = torch.stack(
        [sum(rot[:, i, j] * s_eps[:, j] for j in range(3)) for i in range(3)], dim=-1)
    op = torch.sigmoid(scene.logit_opacities[:, 0])
    gate = torch.sigmoid(-100.0 * (op - optim.sgld_opacity_knee))
    scale = lr * optim.noise_lr * gate * scene.alive
    return shaped * scale[:, None]


def make_train_step(settings: RenderSettings, optim: OptimizationParams,
                    max_sh_degree: int, sh_anneal_interval: int = 1000, seed: int = 0):
    """step(state, cams (B, 3), targets (B, num_r), box_points, c, delta_t,
    volume_position, layout=None) -> StepAux, updating `state` in place
    (`layout`: a frozen rsort layout the renders use, as in JAX).

    The update is always applied; `StepAux.overflow` says on the device
    whether a capacity saturated, and `fit` replays from a snapshot when it
    did (JAX's semantics). The step reads no device value on the host.

    With `optim.sgld_noise` the positions take `sgld_position_noise` after
    the update, from the updated scene, at JAX's lr: the unscaled position
    schedule at the pre-update step counter (not Adam's count), with normals
    keyed on (seed, step) (`ops.random.normal`; JAX keys
    fold_in(PRNGKey(seed), step))."""
    sgld_lr = expon_lr_schedule_tensor(
        lr_init=optim.position_lr_init,
        lr_final=optim.position_lr_final,
        lr_delay_mult=optim.position_lr_delay_mult,
        max_steps=optim.position_lr_max_steps,
    ) if optim.sgld_noise else None

    def train_step(state: TrainState, cams, targets, box_points, c, delta_t,
                   volume_position, layout=None) -> StepAux:
        params = group_params(state.scene)
        loss, aux = batched_loss_fn(
            state.scene, cams, targets, box_points, c, delta_t,
            volume_position, state.active_sh_degree, settings, optim, layout,
        )
        state.opt_state.tx.update(state.opt_state, params, param_grads(loss, params))
        with torch.no_grad():
            if sgld_lr is not None:
                sc = state.scene
                eps = prng.normal(seed, state.step, tuple(sc.means.shape), sc.means.dtype,
                                  lane0=SGLD_LANE0)
                sc.means.add_(sgld_position_noise(sc, eps, sgld_lr(state.step), optim))
        advance_step(state, max_sh_degree, sh_anneal_interval)
        return aux

    return train_step


def param_grads(loss, params) -> list:
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


@torch.no_grad()
def advance_step(state: TrainState, max_sh_degree: int, sh_anneal_interval: int) -> None:
    """The step counter's increment and the SH-degree bump (a device
    `where`: every `sh_anneal_interval` steps, up to `max_sh_degree`)."""
    state.step.add_(1)
    bump = (state.step % sh_anneal_interval == 0) & (state.active_sh_degree < max_sh_degree)
    state.active_sh_degree.add_(bump.to(torch.int32))


def stack_aux(auxs) -> StepAux:
    """StepAux of K steps stacked along a leading K axis, overflow OR-ed."""
    return StepAux(
        loss=torch.stack([a.loss for a in auxs]),
        equal_loss=torch.stack([a.equal_loss for a in auxs]),
        pred_hist=torch.stack([a.pred_hist for a in auxs]),
        target_hist=torch.stack([a.target_hist for a in auxs]),
        overflow=torch.stack([a.overflow for a in auxs]).any(),
    )


@contextlib.contextmanager
def sync_errors():
    """Inside, an operation that blocks the host on the card raises
    (`torch.cuda.set_sync_debug_mode("error")`), with its stack."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def densify_fires(optim: OptimizationParams, cur: int) -> bool:
    """True when the densify hook fires at post-update step counter `cur`
    (JAX `fit.densify_fires`; reference `main.py:243-247`): a pure function
    of the iteration, so the host knows where every event falls."""
    return (optim.mcmc_densification_flag
            and optim.densify_from_iter < cur < optim.densify_until_iter
            and cur % optim.densification_interval == 0)


def chunk_layout(settings: RenderSettings, state: TrainState, ref_cam, layout_slack: float,
                 box_points, c, delta_t):
    """The frozen block layout a chunk's steps share (JAX's `multi`): built
    from the state as it enters the chunk, from the reference camera
    `ref_cam` (a (3,) tensor on the state's device) with `layout_slack`, at
    the settings' rsort capacities."""
    grid0 = shell_grid(ref_cam, box_points, settings.num_sampling_points, settings.start,
                       settings.end, c, delta_t)
    sc = state.scene
    return rsort_layout(sc.means, sc.scales, sc.alive, ref_cam, grid0.theta, grid0.phi,
                        grid0.r, settings.rsort_spec, settings.scaling_modifier,
                        slack=layout_slack)


class ScannedTrainStep:
    """K train steps per call (`make_scanned_train_step`).

    CPU tensors: the step runs K times in a loop. CUDA tensors: one step is
    captured into a CUDA graph and replayed K times. The graph reads its
    step's cameras and targets from static (K, B, ...) buffers at a device
    counter, writes the losses and histograms at it and ORs the overflow
    flag, so the host pays one `replay()` a step and reads nothing inside
    the chunk. The graph is captured once per (K, B, bound state and
    constants) after one warm-up step on a side stream (its update undone
    from a snapshot); the settings are fixed, so a re-tune builds a new
    chunk and captures again. The warm-up step, the capture and the
    replays run under `sync_errors`: a blocking host read raises, and so
    does a capture that fails.

    With `densify_seed` (and `optim.mcmc_densification_flag`), a call takes
    `step0`, the state's step counter at entry as the host knows it, and
    runs `densify_step` after each step whose post-update counter
    `densify_fires` (JAX branches in the graph with `lax.cond`; a CUDA
    graph cannot branch, but the host knows where the events fall). On the
    card that densify step is a second graph, captured the same way and
    replayed there; its donors are keyed on the device step counter, so a
    replay of the chunk draws what the first run drew.

    With `ref_cam` (and a backend of the rsort family) every call builds
    one frozen layout (`chunk_layout`) from the state as it enters, and its
    K steps render through it (JAX's `multi`). On the card the build (sort,
    group search, slot scatter) is a third graph, replayed once before the
    step replays into static layout buffers that the step's graph reads:
    the step's graph sorts nothing, and a call the overflow gate repeats
    from its snapshot rebuilds the layout from the restored state. The
    layout buffers belong to the chunk and are captured with its step.

    `step` replaces the train step (`parallel.sharding` passes its sharded
    step); `graphs=False` runs the K steps eagerly on the card too (a step
    whose collectives cannot be captured, gloo's).

    Statistics: `captures`, `replays`, `densify_replays`, `layout_replays`
    (layouts built), of every capture `capture_log` (step, densify and
    layout graph seconds), and of the last `capture_s`, `instantiate_s`
    (from the log) and `launches_per_replay` ({kernel: launches a replay
    of the step's graph})."""

    def __init__(self, settings: RenderSettings, optim: OptimizationParams,
                 max_sh_degree: int, sh_anneal_interval: int = 1000, seed: int = 0,
                 densify_seed: Optional[int] = None, ref_cam=None,
                 layout_slack: float = 0.0, step: Optional[Callable] = None,
                 graphs: bool = True):
        self.settings = settings
        self._optim = optim
        self._step = step or make_train_step(settings, optim, max_sh_degree,
                                             sh_anneal_interval, seed)
        self.graphs = graphs
        self.densify_seed = densify_seed if optim.mcmc_densification_flag else None
        self.ref_cam = (None if ref_cam is None or settings.backend not in RSORT_FAMILY
                        else np.asarray(ref_cam, np.float32).reshape(3))
        self.layout_slack = layout_slack
        self._graph = self._dgraph = self._lgraph = None
        self._layout = None
        self._key = None
        self.captures = 0
        self.replays = 0
        self.densify_replays = 0
        self.layout_replays = 0
        self.capture_log = []
        self.launches_per_replay = {}

    def layout(self, state: TrainState, box_points, c, delta_t):
        """The layout a call from `state` builds (None without `ref_cam`)."""
        if self.ref_cam is None:
            return None
        ref = self.ref_cam
        cam = gmath.device_constant(f"ref_cam {ref.tolist()}", lambda: ref, box_points.device)
        return chunk_layout(self.settings, state, cam, self.layout_slack, box_points, c,
                            delta_t)

    @property
    def capture_s(self) -> Optional[float]:
        return self.capture_log[-1]["capture_s"] if self.capture_log else None

    @property
    def instantiate_s(self) -> Optional[float]:
        return self.capture_log[-1]["instantiate_s"] if self.capture_log else None

    def _densify(self, state: TrainState) -> None:
        densify_step(state.scene, state.opt_state, self.densify_seed, state.step,
                     self._optim.cap_max)

    def _fires(self, step0: Optional[int], k: int) -> list:
        if self.densify_seed is None:
            return [False] * k
        if step0 is None:
            raise ValueError("a densifying chunk needs step0, the state's step counter "
                             "at entry")
        return [densify_fires(self._optim, step0 + i + 1) for i in range(k)]

    def __call__(self, state: TrainState, cams_k, targets_k, box_points, c, delta_t,
                 volume_position, step0: Optional[int] = None) -> StepAux:
        k = cams_k.shape[0]
        fires = self._fires(step0, k)
        if cams_k.device.type == "cpu" or not self.graphs:
            layout = self.layout(state, box_points, c, delta_t)
            self.layout_replays += layout is not None
            auxs = []
            for i in range(k):
                auxs.append(self._step(state, cams_k[i], targets_k[i], box_points, c,
                                       delta_t, volume_position, layout))
                if fires[i]:
                    self._densify(state)
            self.densify_replays += sum(fires)
            return stack_aux(auxs)
        if cams_k.device.type != "cuda":
            raise ValueError(f"no chunk for device {cams_k.device}")
        key = (tuple(cams_k.shape), tuple(targets_k.shape), targets_k.dtype, c, delta_t,
               box_points.data_ptr(), volume_position.data_ptr(),
               tuple(t.data_ptr() for t in state_tensors(state)))
        if key != self._key:
            self._capture(state, cams_k, targets_k, box_points, c, delta_t,
                          volume_position)
            self._key = key
        self._cams.copy_(cams_k)
        self._targets.copy_(targets_k)
        self._i.zero_()
        self._of.zero_()
        with sync_errors():
            if self._lgraph is not None:
                self._lgraph.replay()
                self.layout_replays += 1
            for i in range(k):
                self._graph.replay()
                if fires[i]:
                    self._dgraph.replay()
        self.replays += k
        self.densify_replays += sum(fires)
        return StepAux(loss=self._loss.clone(), equal_loss=self._eq.clone(),
                       pred_hist=self._pred.clone(), target_hist=targets_k,
                       overflow=self._of.clone())

    def _body(self, state, box_points, c, delta_t, volume_position):
        cams = self._cams.index_select(0, self._i)[0]
        targets = self._targets.index_select(0, self._i)[0]
        aux = self._step(state, cams, targets, box_points, c, delta_t, volume_position,
                         self._layout)
        with torch.no_grad():
            self._loss.index_copy_(0, self._i, aux.loss.reshape(1))
            self._eq.index_copy_(0, self._i, aux.equal_loss.reshape(1))
            self._pred.index_copy_(0, self._i, aux.pred_hist[None])
            self._of.logical_or_(aux.overflow)
            self._i.add_(1)

    def _build_layout(self, state, box_points, c, delta_t):
        self._layout = self.layout(state, box_points, c, delta_t)

    def _capture(self, state, cams_k, targets_k, box_points, c, delta_t,
                 volume_position):
        # Release the last graphs' pools (and layout buffers) first.
        self._graph = self._dgraph = self._lgraph = self._layout = None
        k = cams_k.shape[0]
        dev = cams_k.device
        self._cams = cams_k.clone()
        self._targets = targets_k.clone()
        self._i = torch.zeros(1, dtype=torch.int64, device=dev)
        self._of = torch.zeros((), dtype=torch.bool, device=dev)
        self._loss = torch.zeros(k, dtype=targets_k.dtype, device=dev)
        self._eq = torch.zeros(k, dtype=targets_k.dtype, device=dev)
        self._pred = torch.zeros(targets_k.shape, dtype=targets_k.dtype, device=dev)
        log = {}
        if self.ref_cam is not None:
            # The layout graph first: its output tensors are the static
            # buffers the step's graph reads. A replay fills them before the
            # step's warm-up and capture read them.
            self._lgraph, l_cap, l_inst, _ = _capture_graph(
                lambda: self._build_layout(state, box_points, c, delta_t), state, dev)
            with sync_errors():
                self._lgraph.replay()
            log.update(layout_capture_s=l_cap, layout_instantiate_s=l_inst)
        graph, cap_s, inst_s, self.launches_per_replay = _capture_graph(
            lambda: self._body(state, box_points, c, delta_t, volume_position), state, dev)
        log.update(capture_s=cap_s, instantiate_s=inst_s)
        if self.densify_seed is not None:
            self._dgraph, d_cap, d_inst, _ = _capture_graph(lambda: self._densify(state),
                                                            state, dev)
            log.update(densify_capture_s=d_cap, densify_instantiate_s=d_inst)
        self.capture_log.append(log)
        self.captures += 1
        self._graph = graph


def _capture_graph(body: Callable[[], None], state: TrainState, dev):
    """`body()` (which updates `state` in place) captured into a CUDA graph
    after one warm-up run on a side stream (lazy initialisation stays out of
    the graph), undone from a snapshot. Returns (graph, capture s,
    instantiation s, {kernel: wrapper calls recorded})."""
    snap = snapshot_state(state)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), sync_errors():
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    restore_state(state, snap)
    del snap
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # instantiated apart, timed
    before = cuda_build.captured_counts()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph), sync_errors():
        body()
    t1 = time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize(dev)
    after = cuda_build.captured_counts()
    return (graph, t1 - t0, time.perf_counter() - t1,
            {n: after[n] - before[n] for n in after if after[n] != before[n]})


def make_scanned_train_step(settings: RenderSettings, optim: OptimizationParams,
                            max_sh_degree: int, sh_anneal_interval: int = 1000,
                            ref_cam=None, layout_slack: float = 0.0,
                            densify_seed: Optional[int] = None,
                            seed: int = 0) -> ScannedTrainStep:
    """K-step train chunk: step_k(state, cams (K, B, 3), targets (K, B,
    num_r), box_points, c, delta_t, volume_position, step0=None) -> StepAux
    with loss / equal_loss / pred_hist / target_hist stacked along K and
    the overflow flag OR-reduced on the device (`ScannedTrainStep`). With
    `densify_seed` (and `optim.mcmc_densification_flag`) the chunk
    densifies where the per-step path would, its donors keyed on
    (densify_seed, post-update step); `seed` keys the SGLD noise. With
    `ref_cam` (rsort family; other backends ignore it, as in JAX) each call
    builds one frozen layout from the entering state and `ref_cam`, with
    `layout_slack` (which must cover the largest distance from `ref_cam`
    to a scan point, plus the parameters' drift over a chunk), and its K
    steps render through it."""
    return ScannedTrainStep(settings, optim, max_sh_degree, sh_anneal_interval, seed,
                            densify_seed, ref_cam, layout_slack)


# --- scan points, capacities -------------------------------------------------------


def scan_point_stream(
    rng: np.random.Generator, m: int, n: int, batch: int
) -> Iterator[np.ndarray]:
    """Yield (batch,) flat scan indices, reshuffling each epoch."""
    all_idx = np.arange(m * n)
    buf: list[int] = []
    while True:
        rng.shuffle(all_idx)
        buf.extend(all_idx.tolist())
        while len(buf) >= batch:
            out, buf = buf[:batch], buf[batch:]
            yield np.asarray(out, dtype=np.int32)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    losses: np.ndarray
    equal_losses: np.ndarray
    iters_per_sec: float
    # True if any monitored step saturated a culling capacity that could not
    # be healed by re-tuning (should be False for a healthy run).
    overflow_detected: bool = False
    # Number of capacity re-tunes, and the capacities after each
    # ({max_groups, w_max} or {k_max}).
    retunes: int = 0
    retune_caps: list = dataclasses.field(default_factory=list)
    # The chunked path's CUDA graph statistics (`ScannedTrainStep`): chunk,
    # captures, replays, densify_replays, capture_log, last capture_s /
    # instantiate_s, launches_per_replay.
    chunk_stats: Optional[dict] = None


def layout_reference(data: NLOSData) -> Tuple[np.ndarray, float]:
    """(ref_cam, slack) for the frozen-layout cull: the scan-grid centroid
    and its aperture radius plus a parameter-drift allowance of 2 cm."""
    grid = np.asarray(data.camera_grid_positions).T.reshape(-1, 3)
    ref = grid.mean(axis=0).astype(np.float32)
    slack = float(np.max(np.linalg.norm(grid - ref[None, :], axis=1))) + 0.02
    return ref, slack


def probe_scan_points(data: NLOSData) -> np.ndarray:
    """Representative scan points for capacity fitting: the four corners and
    the middle of the scan grid (corners concentrate the population into few
    angular tiles and drive the worst-case culling capacities)."""
    _, m, n = data.shape
    grid = np.asarray(data.camera_grid_positions).T  # (MN, 3)
    ids = [0, n - 1, (m - 1) * n, m * n - 1, (m * n) // 2]
    return grid[sorted(set(ids))]


def _cap_bucket(v: int) -> int:
    """Round a capacity up to the next quarter-power-of-2 step (x1.0, x1.25,
    x1.5, x1.75 within each octave), so repeated re-fits of a slowly growing
    population land on the same value. Caps <= 64 pass through exactly."""
    v = int(v)
    if v <= 64:
        return v
    step = 1 << max((v - 1).bit_length() - 2, 0)
    return -(-v // step) * step


def fit_culling_capacity(settings: RenderSettings, scene, probe_cams, box_points,
                         c: float, delta_t: float, grow_only: bool = True,
                         ref_cam=None, layout_slack: float = 0.0):
    """Fit the active backend's static culling capacities to the scene on
    the (P, 3) probe scan points. Returns (settings, changed).

    'pallas': for each probe, double `tile_spec.k_max` until its cull stops
    saturating (at most 8 doublings a probe; the reported count is clamped
    at k_max, so it is not trusted), printing each raise. The rsort family:
    `tune_rsort_spec`, with `ref_cam` against one frozen layout from it
    (`layout_slack`), as the chunks of a frozen-layout run render; with
    `grow_only` (the runtime re-tune) the caps only grow, to
    quarter-power-of-2 buckets. 'pallas_dsort': `tune_dsort_spec` (no
    layout, as in JAX), and with `grow_only` the element-wise maxima of
    `d_max`, `dup_rows` and `w_max` (unbucketed, as JAX's). Backends
    without capacities return the settings unchanged."""
    dev = scene.means.device
    cams = torch.as_tensor(np.asarray(probe_cams, np.float32), device=dev).reshape(-1, 3)
    if settings.backend == "pallas_dsort":
        cur = settings.rsort_spec
        fitted = tune_dsort_spec(
            scene, cams, box_points, settings.num_sampling_points, settings.start,
            settings.end, c, delta_t, base=cur, scaling_modifier=settings.scaling_modifier,
        )
        new = cur._replace(d_max=max(cur.d_max, fitted.d_max),
                           dup_rows=max(cur.dup_rows, fitted.dup_rows),
                           w_max=max(cur.w_max, fitted.w_max)) if grow_only else fitted
        return settings._replace(rsort_spec=new), new != cur
    if settings.backend in RSORT_FAMILY:
        cur = settings.rsort_spec
        fitted = tune_rsort_spec(
            scene, cams, box_points, settings.num_sampling_points, settings.start,
            settings.end, c, delta_t, base=cur,
            scaling_modifier=settings.scaling_modifier, ref_cam=ref_cam,
            slack=layout_slack,
        )
        if grow_only:
            new = cur._replace(
                max_groups=max(cur.max_groups, _cap_bucket(fitted.max_groups)),
                w_max=max(cur.w_max, _cap_bucket(fitted.w_max)),
            )
        else:
            new = fitted
        return settings._replace(rsort_spec=new), new != cur
    if settings.backend == "pallas":
        changed = False
        for cam in cams:
            diag = check_culling_capacity(scene, cam, box_points, c, delta_t, settings)
            tries = 0
            while diag["overflowed"] and tries < 8:
                new_k = 2 * settings.tile_spec.k_max
                print(f"culling capacity saturated ({diag}); raising k_max -> {new_k}")
                settings = settings._replace(
                    tile_spec=settings.tile_spec._replace(k_max=new_k)
                )
                changed = True
                tries += 1
                diag = check_culling_capacity(scene, cam, box_points, c, delta_t,
                                              settings)
        return settings, changed
    return settings, False


# --- fit ---------------------------------------------------------------------------


def prepare_training(
    cfg: Config,
    optim: OptimizationParams,
    data: NLOSData,
    init_points: Optional[np.ndarray] = None,
    init_rhos: Optional[np.ndarray] = None,
    seed: Optional[int] = None,
    device=None,
):
    """Create (scene, tx, settings, box_points) from config + data, on
    `device` (by default the CUDA card).

    Without init points, uniform random-in-volume init with the reference's
    margin semantics (`init_rand_points`) from `cfg.rng` (or `seed`). The
    kernel backends' capacities are fitted to the initial population on the
    probe scan points (`grow_only=False`), against the frozen layout of
    `layout_reference(data)` when `cfg.frozen_layout` is set."""
    from nlos_gaussian_renderer_tpu_torch.utils.init import init_rand_points

    dev = gmath.default_device(device)
    rng = np.random.default_rng(cfg.rng if seed is None else seed)
    pmin = data.volume_position - data.volume_size / 2
    pmax = data.volume_position + data.volume_size / 2
    if init_points is None:
        init_points, init_rhos = init_rand_points(
            rng, cfg.init_gaussian_num, pmin, pmax, margin=cfg.init_sample_margin
        )
    scene = init_scene(init_points, init_rhos, pmin, pmax, max_sh_degree=cfg.sh_degree,
                       capacity=cfg.capacity(optim), device=dev)
    tx = make_optimizer(optim)
    settings = RenderSettings.from_config(cfg)
    box_points = gmath.volume_box_points(data.volume_position, data.volume_size,
                                         device=dev)
    probes = probe_scan_points(data)
    ref_cam, layout_slack = layout_reference(data) if cfg.frozen_layout else (None, 0.0)
    settings, _ = fit_culling_capacity(settings, scene, probes, box_points, data.c,
                                       data.deltaT, grow_only=False, ref_cam=ref_cam,
                                       layout_slack=layout_slack)
    if settings.backend in KERNEL_BACKENDS:
        diag = check_culling_capacity(scene, torch.as_tensor(probes[-1], device=dev),
                                      box_points, data.c, data.deltaT, settings)
        if diag["overflowed"]:
            print(f"WARNING: culling capacity saturated — raise caps! {diag}")
        else:
            print(f"culling capacity ok: {diag}")
    return scene, tx, settings, box_points


def culling_caps(settings: RenderSettings) -> dict:
    """The culling capacities that `fit_culling_capacity` tunes for the
    backend: d_max, dup_rows and w_max (pallas_dsort); max_groups and
    w_max (the rsort family); k_max (pallas)."""
    if settings.backend == "pallas_dsort":
        caps = settings.rsort_spec
        return dict(d_max=caps.d_max, dup_rows=caps.dup_rows, w_max=caps.w_max)
    if settings.backend in RSORT_FAMILY:
        caps = settings.rsort_spec
        return dict(max_groups=caps.max_groups, w_max=caps.w_max)
    return dict(k_max=settings.tile_spec.k_max)


def _caps_text(settings: RenderSettings) -> str:
    return " ".join(f"{k}={v}" for k, v in culling_caps(settings).items())


class OverflowGate:
    """The overflow gate of `fit` (JAX's `retune`, `force_grow_caps` and
    `run_gated`): the current step and chunk builders of `settings`, and the
    re-tunes that grow the capacities.

    `run_gated` runs one step or chunk from a snapshot of the state; when
    its render overflowed a capacity it restores the snapshot, re-fits
    (grow only) and runs again, so no truncated gradient reaches the
    optimizer. A re-fit that changes nothing marks `overflow_detected` and
    keeps the overflowed result. The re-fit culls the probe scan points
    and, unlike JAX's (probes only), the overflowed step's, chunk's or
    window's own cameras: a scan point the probes miss is healed, not
    recorded (the 256x256 grid's five probes do not bound `k_max` at
    100k). With `ref_cam` (frozen layouts) the chunk builds its layouts
    from it and every re-fit culls against one; the single step renders
    without a layout, as JAX's `fit` does."""

    def __init__(self, settings: RenderSettings, optim: OptimizationParams,
                 max_sh_degree: int, probe_cams, box_points, c: float, delta_t: float,
                 sh_anneal_interval: int = 1000, seed: int = 0,
                 densify_seed: Optional[int] = None, ref_cam=None,
                 layout_slack: float = 0.0):
        self.settings = settings
        self.retunes = 0
        self.retune_caps = []
        self.overflow_detected = False
        self._optim, self._max_sh = optim, max_sh_degree
        self._interval = sh_anneal_interval
        self._seed, self._densify_seed = seed, densify_seed
        self._ref_cam, self._layout_slack = ref_cam, layout_slack
        self._probes = np.asarray(probe_cams, np.float32).reshape(-1, 3)
        self._box, self._c, self._dt = box_points, c, delta_t
        self.step = make_train_step(settings, optim, max_sh_degree, sh_anneal_interval, seed)
        self.chunk = None

    def enable_chunk(self) -> ScannedTrainStep:
        self.chunk = make_scanned_train_step(self.settings, self._optim, self._max_sh,
                                             self._interval, ref_cam=self._ref_cam,
                                             layout_slack=self._layout_slack,
                                             densify_seed=self._densify_seed,
                                             seed=self._seed)
        return self.chunk

    def _rebuild(self, settings: RenderSettings) -> None:
        self.settings = settings
        self.step = make_train_step(settings, self._optim, self._max_sh, self._interval,
                                    self._seed)
        if self.chunk is not None:
            old = self.chunk
            self.enable_chunk()
            self.chunk.captures += old.captures
            self.chunk.replays += old.replays
            self.chunk.densify_replays += old.densify_replays
            self.chunk.layout_replays += old.layout_replays
            # The last capture's statistics stand until the new chunk captures.
            self.chunk.capture_log = old.capture_log
            self.chunk.launches_per_replay = old.launches_per_replay
        self.retunes += 1
        self.retune_caps.append(culling_caps(settings))

    def retune(self, state: TrainState, cams=None) -> bool:
        """Grow the capacities to the state's population on the probes (and
        `cams`, any shape (..., 3)); rebuild on change."""
        probes = self._probes
        if cams is not None:
            probes = np.concatenate(
                [probes, cams.detach().reshape(-1, 3).cpu().numpy().astype(np.float32)])
        new, changed = fit_culling_capacity(self.settings, state.scene, probes,
                                            self._box, self._c, self._dt,
                                            ref_cam=self._ref_cam,
                                            layout_slack=self._layout_slack)
        if changed:
            self._rebuild(new)
            print(f"culling capacities re-tuned: {_caps_text(new)}")
        return changed

    def force_grow_caps(self, state: TrainState) -> bool:
        """Grow the work-list caps 25% past the fit (the escalation for
        growth inside a chunk): `max_groups` and `w_max`, on the rsort
        family and on 'pallas_dsort', whose `d_max` and `dup_rows` JAX
        leaves as they are; False for backends without such caps."""
        if self.settings.backend not in RSPEC_BACKENDS:
            return False
        caps = self.settings.rsort_spec
        self._rebuild(self.settings._replace(rsort_spec=caps._replace(
            max_groups=int(caps.max_groups * 1.25) + 1,
            w_max=int(caps.w_max * 1.25) + 1,
        )))
        print(f"culling capacities force-grown past the fit: {_caps_text(self.settings)}")
        return True

    def run_gated(self, chunked: bool, state: TrainState, cams, *args, what: str = "",
                  may_densify: bool = False, **kw) -> StepAux:
        """One step (or chunk) of the current builders with the gate: one
        host read of the overflow flag after it. `kw` goes to the chunk
        (`step0` where it densifies)."""
        snap = snapshot_state(state)
        aux = (self.chunk if chunked else self.step)(state, cams, *args, **kw)
        replays = 0
        while bool(aux.overflow):
            if replays == 4:
                # Still overflowing after the last replay: keep the result
                # and record the failure.
                self.overflow_detected = True
                break
            replays += 1
            print(f"WARNING: culling capacity overflow in {what} — re-tuning caps "
                  "and re-running from the pre-overflow state")
            restore_state(state, snap)
            grown = (self.retune(state, cams)
                     or (may_densify and self.force_grow_caps(state)))
            aux = (self.chunk if chunked else self.step)(state, cams, *args, **kw)
            if not grown:
                # Caps at the fitted maximum and still overflowing: keep the
                # (superset-capped) result and record the failure.
                self.overflow_detected = True
                break
        return aux


def fit(
    cfg: Config,
    optim: OptimizationParams,
    data: NLOSData,
    num_iters: Optional[int] = None,
    init_points: Optional[np.ndarray] = None,
    init_rhos: Optional[np.ndarray] = None,
    log_every: Optional[int] = None,
    callback: Optional[Callable[[int, TrainState, StepAux], None]] = None,
    init_state: Optional[TrainState] = None,
    callback_every: Optional[int] = None,
    device=None,
) -> FitResult:
    """Run the training loop (reference `train`, `main.py:273-371`), on
    `device` (by default the CUDA card; `device='cpu'` runs the kernels'
    plain versions).

    The scan points come from `scan_point_stream(default_rng(cfg.rng))`, as
    in JAX. `init_state` is copied (`clone_state`) and left as it was; the
    result's state is the trained copy. Callback cadence: with
    `callback_every=k` the callback fires where (it + 1) % k == 0 (and at
    the last iteration) and the chunked path stays on; without it a
    callback forces the per-step path and fires every iteration. Each call
    gets a detached copy of the state, its own.

    Chunked path: K from (50, 25, 20, 10, 5, 4, 2), the largest dividing
    the log / callback cadence, K steps per `make_scanned_train_step` call
    (a CUDA graph replayed K times on the card), single steps for the tail;
    the losses are read once a log window. Per-step path: the overflow flag
    is OR-ed on the device and read at log boundaries. Either way a chunk
    or window whose render overflowed a capacity is replayed from its
    starting state after a re-tune, so the final parameters equal a run
    whose caps were big enough from the start, bit for bit, on the CPU and
    on the card (every kernel backend sums in a fixed order; `pallas`'s row
    gather adds its cotangents one tile at a time, `fused.TakeRows`).

    MCMC densification (`optim.mcmc_densification_flag`) runs
    `densify_step` after each step whose post-update counter
    `densify_fires`: inside the chunk (a second graph on the card), host
    side after a single step, and replayed in order with the per-step
    window; the capacities are re-tuned after each chunk or step that
    densified. The donors and the SGLD noise are keyed on the device step
    counter, so both paths and every replay draw the same.

    `cfg.frozen_layout` (rsort family): each chunk renders through one
    block layout built at its entry from `layout_reference(data)` (the
    scan-grid centroid, its aperture radius + 2 cm), and the caps are fitted
    against such a layout; single steps (the tail, the per-step path, and
    so every densified frozen-layout run) render without one, as in JAX.
    """
    num_iters = num_iters if num_iters is not None else optim.iterations
    log_every = log_every if log_every is not None else cfg.print_interval
    rng = np.random.default_rng(cfg.rng)

    scene, tx, settings, box_points = prepare_training(
        cfg, optim, data, init_points, init_rhos, device=device
    )
    dev = box_points.device
    state = clone_state(init_state) if init_state is not None else create_train_state(scene, tx)
    # The step counter at entry, read once: densify events fall at the
    # post-update counters step0 + it + 1 (JAX's it + 2 from a fresh state).
    step0 = int(state.step)
    densify_seed = cfg.rng + 1

    def fires(it: int) -> bool:
        return densify_fires(optim, step0 + it + 1)

    def densify_now() -> None:
        densify_step(state.scene, state.opt_state, densify_seed, state.step, optim.cap_max)

    l, m, n = data.shape
    nlos = torch.as_tensor(data.nlos_data.reshape(l, m * n), device=dev)
    # Histogram window [start, end) of every scan point, * gt_times.
    target_all = nlos[cfg.start:cfg.end, :].T.contiguous() * cfg.gt_times
    cam_grid = torch.as_tensor(np.ascontiguousarray(data.camera_grid_positions.T),
                               device=dev)  # (MN, 3)
    vol_pos = torch.as_tensor(data.volume_position, device=dev)
    ref_cam, layout_slack = layout_reference(data) if cfg.frozen_layout else (None, 0.0)
    gate = OverflowGate(settings, optim, cfg.sh_degree, probe_scan_points(data),
                        box_points, data.c, data.deltaT, seed=cfg.rng,
                        densify_seed=densify_seed, ref_cam=ref_cam,
                        layout_slack=layout_slack)
    consts = (box_points, data.c, data.deltaT, vol_pos)

    # The whole run's scan points, drawn up front (the stream is consumed
    # once an iteration, replays reuse theirs) and copied once: no host data
    # crosses to the device inside the loop.
    stream = scan_point_stream(rng, m, n, cfg.batch_size)
    idx_all = torch.as_tensor(
        np.stack([next(stream) for _ in range(num_iters)]).astype(np.int64), device=dev
    ) if num_iters else torch.zeros((0, cfg.batch_size), dtype=torch.int64, device=dev)

    def gather_batch(idx):
        return cam_grid[idx], target_all[idx]

    losses, eqs = [], []
    cadence = log_every
    if callback is not None:
        cadence = math.gcd(log_every, callback_every) if callback_every else 0
    chunk = 1
    # A frozen layout cannot follow a densify event inside a chunk (a
    # relocated Gaussian may leave the layout's slack), so a densified
    # frozen-layout run takes the per-step path, whose steps use no layout
    # (JAX's `densify_chunk_ok`).
    if cadence and not (optim.mcmc_densification_flag and cfg.frozen_layout):
        for cand in (50, 25, 20, 10, 5, 4, 2):
            if cadence % cand == 0 and num_iters >= cand:
                chunk = cand
                break

    def fire_callback(it_end, aux_last):
        if callback is None:
            return
        if callback_every is None or it_end % callback_every == 0 or it_end == num_iters:
            callback(it_end - 1, clone_state(state), aux_last)

    def finish(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        stats = None
        if gate.chunk is not None:
            ch = gate.chunk
            stats = dict(chunk=chunk, captures=ch.captures, replays=ch.replays,
                         densify_replays=ch.densify_replays,
                         layout_replays=ch.layout_replays,
                         capture_log=list(ch.capture_log),
                         capture_s=ch.capture_s, instantiate_s=ch.instantiate_s,
                         launches_per_replay=dict(ch.launches_per_replay))
        return FitResult(
            state=state,
            losses=np.asarray(losses),
            equal_losses=np.asarray(eqs),
            iters_per_sec=num_iters / max(dt, 1e-9),
            overflow_detected=gate.overflow_detected,
            retunes=gate.retunes,
            retune_caps=list(gate.retune_caps),
            chunk_stats=stats,
        )

    if chunk > 1:
        gate.enable_chunk()
        t0 = time.perf_counter()
        it = 0
        while it < num_iters:
            k = chunk if it + chunk <= num_iters else 1
            # A densify event inside [it, it + k)? Inside the chunk for
            # k > 1, host side for the k == 1 tail; either way the caps are
            # re-fitted to the grown population right after.
            densified = any(fires(j) for j in range(it, it + k))
            if k > 1:
                cams, targets = gather_batch(idx_all[it:it + k])  # (k, B, ...)
                auxs = gate.run_gated(True, state, cams, targets, *consts,
                                      what=f"chunk ending at iter {it + k}",
                                      may_densify=densified, step0=step0 + it)
                aux = StepAux(
                    loss=auxs.loss[-1], equal_loss=auxs.equal_loss[-1],
                    pred_hist=auxs.pred_hist[-1], target_hist=auxs.target_hist[-1],
                    overflow=auxs.overflow,
                )
            else:
                cams, targets = gather_batch(idx_all[it])
                aux = gate.run_gated(False, state, cams, targets, *consts,
                                     what=f"iter {it + 1}")
                if densified:
                    densify_now()
            if densified:
                gate.retune(state)
            it += k
            if it % log_every == 0 or it == num_iters:
                losses.append(float(aux.loss))
                eqs.append(float(aux.equal_loss))
            fire_callback(it, aux)
        return finish(t0)

    # Per-step path: the overflow flag is accumulated on the device and read
    # at log boundaries; on overflow the window since the last boundary is
    # replayed, steps and densify events in order, from its retained
    # starting state with re-tuned caps.
    of_acc = torch.zeros((), dtype=torch.bool, device=dev)
    window_start = snapshot_state(state)
    window_events: list = []  # ("step", it) | ("densify", it)
    t0 = time.perf_counter()
    for it in range(num_iters):
        cams, targets = gather_batch(idx_all[it])
        aux = gate.step(state, cams, targets, *consts)
        window_events.append(("step", it))
        if fires(it):
            densify_now()
            window_events.append(("densify", it))
            # The population just grew: re-fit the capacities before the
            # next render can truncate.
            gate.retune(state)
        of_acc = of_acc | aux.overflow
        if (it + 1) % log_every == 0 or it == num_iters - 1:
            replays = 0
            while bool(of_acc):
                if replays == 4:
                    gate.overflow_detected = True
                    break
                replays += 1
                print(f"WARNING: culling capacity overflow by iter {it + 1} — "
                      "re-tuning caps and replaying the window")
                steps = [j for ev, j in window_events if ev == "step"]
                if not gate.retune(state, cam_grid[idx_all[steps]]):
                    gate.overflow_detected = True
                    break
                restore_state(state, window_start)
                of_acc = torch.zeros((), dtype=torch.bool, device=dev)
                for ev, j in window_events:
                    if ev == "densify":
                        densify_now()
                        continue
                    cams_r, targets_r = gather_batch(idx_all[j])
                    aux = gate.step(state, cams_r, targets_r, *consts)
                    of_acc = of_acc | aux.overflow
            losses.append(float(aux.loss))
            eqs.append(float(aux.equal_loss))
            of_acc = torch.zeros((), dtype=torch.bool, device=dev)
            window_start = snapshot_state(state)
            window_events = []
        if callback is not None and callback_every is None:
            callback(it, clone_state(state), aux)
        else:
            fire_callback(it + 1, aux)
    return finish(t0)
