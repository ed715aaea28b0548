"""The sharded train step: scan-point data parallelism x Gaussian sharding.

Port of `nlos_gaussian_renderer_tpu/parallel/sharding.py` over
`torch.distributed` (a `mesh.Mesh`):

  - the batch of scan points is split over the `scan` axis; each rank
    renders its scan points whole, and the gradients (with the loss) are
    averaged over `scan`, one collective a step;
  - the Gaussian rows and their Adam moments are split over the `gauss`
    axis (`shard_scene`); every sum over Gaussians in the renderer and the
    regularizers is summed over `gauss` (`ops.render.GaussSum`, at JAX's
    `gauss_axis` reduction points).

Two departures from the JAX step, both reference caveats there (the JAX
package stays as it is):

  - JAX takes `value_and_grad` inside `shard_map(..., check_vma=False)`,
    where the transpose of `psum` is a `psum`: its gradients are `n_gauss`
    times the true ones (Adam hides a constant scale, up to eps). Here
    `GaussSum`'s backward passes the cotangent through, so the gradients
    equal the single-device step's.
  - JAX reduces the overflow flag over `scan` only and returns shard 0's:
    a capacity saturated on another Gaussian shard is lost. Here the flag
    is reduced over both axes.

Gathers are all-reduces of a zero buffer holding each rank's block (exact:
every entry is one rank's value plus zeros), so one collective, the sum,
serves NCCL and gloo alike, CUDA tensors included. Like JAX's sharded
step, this one adds no SGLD noise and takes no frozen layout.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
from nlos_gaussian_renderer_tpu_torch.parallel.mesh import Mesh


def gather_rows(x, group, n: int, idx: int):
    """(n * rows, ...) blocks of the `n` ranks of `group` in axis order,
    `x` being this rank's (at axis index `idx`)."""
    rows = x.shape[0]
    buf = x.new_zeros((n * rows,) + tuple(x.shape[1:]))
    buf[idx * rows:(idx + 1) * rows] = x
    dist.all_reduce(buf, group=group)
    return buf


def named_state_tensors(state: train.TrainState) -> list:
    """(name, tensor) of every tensor of a state: the scene's fields, both
    Adam moments of each group, the counters."""
    o = state.opt_state
    return ([(f"scene.{n}", getattr(state.scene, n)) for n in FIELD_NAMES]
            + [(f"mu.{g}", m) for g, m in zip(train.GROUPS, o.mu)]
            + [(f"nu.{g}", v) for g, v in zip(train.GROUPS, o.nu)]
            + [("count", o.count), ("step", state.step),
               ("active_sh_degree", state.active_sh_degree)])


def _leaf_spec(t, capacity: int, gauss_axis: str) -> tuple:
    """Shard any tensor whose leading dimension is the Gaussian capacity."""
    if t.ndim >= 1 and t.shape[0] == capacity:
        return (gauss_axis,) + (None,) * (t.ndim - 1)
    return ()


def state_specs(state: train.TrainState, gauss_axis: str = "gauss") -> dict:
    """{name: spec} of `named_state_tensors`: (gauss_axis, None, ...) for the
    scene's and the moments' rows, () (replicated) for the counters (JAX's
    PartitionSpecs as tuples)."""
    cap = state.scene.capacity
    return {n: _leaf_spec(t, cap, gauss_axis) for n, t in named_state_tensors(state)}


def shard_scene(state: train.TrainState, mesh: Mesh) -> train.TrainState:
    """This rank's state: its contiguous block of the scene's rows and of
    both Adam moments (block `gauss_idx` of `n_gauss`), the counters
    replicated, on `mesh.device`. The capacity must divide by `n_gauss`."""
    cap = state.scene.capacity
    if cap % mesh.n_gauss:
        raise ValueError(f"capacity {cap} does not divide over {mesh.n_gauss} gauss shards")
    n = cap // mesh.n_gauss
    lo = mesh.gauss_idx * n

    def rows(t):
        return t.detach()[lo:lo + n].to(mesh.device, copy=True)

    def rep(t):
        return t.detach().to(mesh.device, copy=True)

    o = state.opt_state
    return train.TrainState(
        scene=GaussianScene(*(rows(getattr(state.scene, f)) for f in FIELD_NAMES)),
        opt_state=train.AdamState(tx=o.tx, mu=[rows(m) for m in o.mu],
                                  nu=[rows(v) for v in o.nu], count=rep(o.count)),
        step=rep(state.step), active_sh_degree=rep(state.active_sh_degree),
    )


def sharded_value_and_grad(mesh: Mesh, settings: RenderSettings, optim: OptimizationParams,
                           state: train.TrainState, cams, targets, box_points, c, delta_t,
                           volume_position):
    """(gradients of this rank's rows, GROUPS order, StepAux) of one batch:
    this rank renders its `scan` block of the (B, 3) scan points with its
    Gaussian shard (fields summed over `gauss`); gradients, loss and equal
    loss are averaged over `scan`; the overflow flag is OR-ed over every
    rank; `pred_hist` gathered over `scan` to (B, num_r)."""
    b = cams.shape[0]
    if b % mesh.n_scan:
        raise ValueError(f"batch {b} does not divide over {mesh.n_scan} scan shards")
    nb = b // mesh.n_scan
    lo = mesh.scan_idx * nb
    params = train.group_params(state.scene)
    loss, aux = train.batched_loss_fn(
        state.scene, cams[lo:lo + nb], targets[lo:lo + nb], box_points, c, delta_t,
        volume_position, state.active_sh_degree, settings, optim,
        gauss_group=mesh.gauss_group,
    )
    grads = train.param_grads(loss, params)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [aux.loss.reshape(1), aux.equal_loss.reshape(1)])
    dist.all_reduce(flat, group=mesh.scan_group)
    flat = flat / mesh.n_scan
    sizes = [g.numel() for g in grads]
    parts = torch.split(flat, sizes + [1, 1])
    grads = [p.reshape(g.shape) for p, g in zip(parts, grads)]
    overflow = aux.overflow.to(torch.int32).reshape(1)
    dist.all_reduce(overflow)  # both axes: every rank
    return grads, train.StepAux(
        loss=parts[-2][0], equal_loss=parts[-1][0],
        pred_hist=gather_rows(aux.pred_hist, mesh.scan_group, mesh.n_scan, mesh.scan_idx),
        target_hist=targets, overflow=overflow[0] > 0,
    )


def make_sharded_train_step(mesh: Mesh, settings: RenderSettings, optim: OptimizationParams,
                            max_sh_degree: int, sh_anneal_interval: int = 1000) -> Callable:
    """step(state, cams (B, 3), targets (B, num_r), box_points, c, delta_t,
    volume_position) -> StepAux, updating this rank's shard (`shard_scene`)
    in place: `sharded_value_and_grad`, then Adam on the rank's rows, the
    step counter and the SH bump. B must divide by `n_scan`. It reads no
    device value on the host (a CUDA graph can hold it on NCCL)."""

    def step(state, cams, targets, box_points, c, delta_t, volume_position, layout=None):
        if layout is not None:
            raise ValueError("the sharded step renders without a frozen layout, as JAX's")
        grads, aux = sharded_value_and_grad(mesh, settings, optim, state, cams, targets,
                                            box_points, c, delta_t, volume_position)
        state.opt_state.tx.update(state.opt_state, train.group_params(state.scene), grads)
        train.advance_step(state, max_sh_degree, sh_anneal_interval)
        return aux

    return step


def make_sharded_scanned_train_step(mesh: Mesh, settings: RenderSettings,
                                    optim: OptimizationParams, max_sh_degree: int,
                                    sh_anneal_interval: int = 1000
                                    ) -> train.ScannedTrainStep:
    """K sharded steps a call, the contract of `train.make_scanned_train_step`
    (step_k(state, cams (K, B, 3), targets (K, B, num_r), ...) -> StepAux
    stacked along K, overflow OR-ed). On NCCL with CUDA tensors one sharded
    step, its collectives included, is captured into a CUDA graph and
    replayed K times; on gloo the K steps run eagerly."""
    step = make_sharded_train_step(mesh, settings, optim, max_sh_degree, sh_anneal_interval)
    return train.ScannedTrainStep(settings, optim, max_sh_degree, sh_anneal_interval,
                                  step=step, graphs=mesh.backend == "nccl")


def make_sharded_densify_step(mesh: Mesh, cap_max: int, seed: int) -> Callable:
    """densify(state): MCMC densification of a Gaussian-sharded state, in
    place. The scene's and the moments' rows are gathered over `gauss`,
    `models.densify.densify_step` runs whole on every rank (its draws are
    keyed on (seed, the device step counter), so every rank draws the
    same), and each rank keeps its own rows: the result equals the
    single-device densify step's bit for bit."""

    @torch.no_grad()
    def densify(state: train.TrainState) -> None:
        def full(t):
            return gather_rows(t.detach(), mesh.gauss_group, mesh.n_gauss, mesh.gauss_idx)

        sc, o = state.scene, state.opt_state
        scene = GaussianScene(*(full(getattr(sc, f)) for f in FIELD_NAMES))
        opt = train.AdamState(tx=o.tx, mu=[full(m) for m in o.mu],
                              nu=[full(v) for v in o.nu], count=o.count)
        densify_step(scene, opt, seed, state.step, cap_max)
        n = sc.capacity
        lo = mesh.gauss_idx * n
        mine = [getattr(sc, f) for f in FIELD_NAMES] + o.mu + o.nu
        whole = [getattr(scene, f) for f in FIELD_NAMES] + opt.mu + opt.nu
        for t, w in zip(mine, whole):
            t.copy_(w[lo:lo + n])

    return densify
