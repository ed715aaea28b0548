"""The inputs of a run, made from its seed on the run's device: the Gaussian
population, the Adam state, the step counter, the scan grid and the target
transients. The program and the reference are handed the same tensors.

Frozen copies, so that a change to the program cannot move the yardstick:

- the population is the bench scene of
  `nlos_gaussian_renderer_tpu_torch/tools/__init__.py:bench_scene` (commit
  698b441) with `random_pose`: means uniform in the central 0.36 m cube of
  the hidden volume (centre (0, 1, 0), edge 0.6 m), albedo U(0.3, 0.9) as
  its DC band, opacity 0.8, log-uniform scales in the traffic's sigma range
  (`tools/geomsweep.py:PROXY_SIGMA` (0.03, 0.07) m for the converged
  population, `bench.py`'s (0.002, 0.012) m for the sparse one), normal
  quaternions and 0.1-normal higher SH bands; dead slots as
  `models/scene.py:init_scene` pads them (mean 0, log-scale -6, identity
  quaternion, opacity 0.1, SH 0). Drawn with a `torch.Generator` on the
  device in a few large calls, not with the bench's numpy generator;
- the scan grid is `data/synthetic.py:make_scan_grid` (256 x 256 points on
  the y = 0 wall over +-0.4 m), the order of scan points
  `train.py:scan_point_stream` (a fresh shuffle of every point each epoch,
  from `numpy.random.default_rng(rng)`), and the capacity probes
  `train.py:probe_scan_points` (the grid's four corners and middle).

The geometry the cull and the kernels' work follow, the means and the
scales, is drawn from the traffic's own `population_seed`: every seed of a
cell trains the same sizes, so its work, and the capacities `fit` fits to
it, do not change from seed to seed. Rotations, albedos, SH bands, targets
and the scan order come from the run's seed.

The targets: each scan point's histogram is the mean of the reference's
renders of the population at five interior scan points (`level_points`),
bin by bin, times U(0.5, 1.5) noise drawn per (scan point, bin), so that
the loss neither pulls the population up nor down on the whole and its
widths stay near the traffic's range through a window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference

# The hidden volume and the time axis of the bench scene (`bench.py:34-46`).
VOLUME_POSITION = (0.0, 1.0, 0.0)
VOLUME_SIZE = 0.6
C_LIGHT = 1.0
DELTA_T = 0.0052
GT_TIMES = 100.0  # `Config.gt_times`: targets are scaled by it before the MSE


def scene_constants(config: dict) -> dict:
    """The grid constants of a configuration, as the reference takes them."""
    return dict(volume_position=list(VOLUME_POSITION), volume_size=VOLUME_SIZE,
                ns=config["num_sampling_points"], start=config["start"], end=config["end"],
                c=C_LIGHT, dt=DELTA_T)


def make_scan_grid(m: int, n: int, half: float = 0.4) -> np.ndarray:
    """(3, M*N) scan positions on the y = 0 wall over an (x, z) grid."""
    xs = np.linspace(-half, half, m)
    zs = np.linspace(-half, half, n)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    return np.stack([xx.ravel(), np.zeros(m * n), zz.ravel()], axis=0).astype(np.float32)


def scan_order(rng_seed: int, m: int, n: int, steps: int) -> np.ndarray:
    """(steps,) flat scan indices, one a step (batch 1): every point once
    an epoch, a fresh shuffle each epoch."""
    rng = np.random.default_rng(rng_seed)
    all_idx = np.arange(m * n)
    out = []
    while len(out) < steps:
        rng.shuffle(all_idx)
        out.extend(all_idx.tolist())
    return np.asarray(out[:steps], dtype=np.int64)


def probe_points(grid: np.ndarray, m: int, n: int) -> np.ndarray:
    """(P, 3) the grid's four corners and middle."""
    ids = sorted({0, n - 1, (m - 1) * n, m * n - 1, (m * n) // 2})
    return grid.T[ids]


def program_seed(seed: int) -> int:
    """The program's own integer seed (`Config.rng`: the scan order, the
    densify and noise keys), drawn from the run's seed."""
    return int(np.random.SeedSequence(seed).generate_state(1)[0] % (2**31 - 1))


def population(geometry: torch.Generator, gen: torch.Generator, slots: int, alive: int,
               sigma, sh_degree: int, device) -> dict:
    """The scene's seven fields (float32, on `device`): `alive` Gaussians of
    the bench scene at log-uniform sigma in `sigma`, then dead slots. The
    geometry the cull and the kernels' work follow (means, scales) is drawn
    from `geometry`; rotations and albedos from `gen`."""
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(g, shape, lo, hi):
        return torch.rand(shape, generator=g, **f32) * (hi - lo) + lo

    half = 0.3 * VOLUME_SIZE
    k = (sh_degree + 1) ** 2
    means = torch.as_tensor(VOLUME_POSITION, **f32) + uniform(geometry, (alive, 3), -half, half)
    log_s = uniform(geometry, (alive, 3), math.log(sigma[0]), math.log(sigma[1]))
    rho = uniform(gen, (alive, 1), 0.3, 0.9)
    quats = torch.randn((alive, 4), generator=gen, **f32)
    sh_rest = 0.1 * torch.randn((alive, k - 1), generator=gen, **f32)
    dead = slots - alive
    logit = lambda p: math.log(p / (1 - p))  # noqa: E731

    def pad(x, fill):
        return torch.cat([x, torch.full((dead,) + tuple(x.shape[1:]), fill, **f32)])

    quats = pad(quats, 0.0)
    quats[alive:, 0] = 1.0
    return dict(
        means=pad(means, 0.0),
        log_scales=pad(log_s, -6.0),
        quats=quats,
        logit_opacities=torch.cat([torch.full((alive, 1), logit(0.8), **f32),
                                   torch.full((dead, 1), logit(0.1), **f32)]),
        sh_dc=pad((rho - 0.5) / reference._C0, 0.0),
        sh_rest=pad(sh_rest, 0.0),
        alive=torch.cat([torch.ones(alive, **f32), torch.zeros(dead, **f32)]),
    )


def level_points(grid: np.ndarray, m: int, n: int) -> np.ndarray:
    """(5, 3) the scan points the target level is rendered at: the middle
    of the grid and of its four quadrants, which sample its interior as a
    random scan point does."""
    ids = [(i * m // 4) * n + j * n // 4 for i, j in ((1, 1), (1, 3), (3, 1), (3, 3), (2, 2))]
    return grid.T[ids]


def make_inputs(config: dict, traffic: dict, seed: int, device, chunk: int = 1024) -> dict:
    """Everything a run hands the program and the reference, from `seed`:
    {'params', 'mu', 'nu', 'count', 'step', 'sh_degree', 'grid' (3, MN)
    numpy, 'order' (steps,) scan indices, 'targets' (L, M, N) tensor of the
    NLOS data (divided by gt_times), 'rng' the program's seed,
    'target_level' (num_r,)}. `traffic['max_steps']` bounds the scan order
    drawn."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    geometry = torch.Generator(device=device)
    geometry.manual_seed(traffic["population_seed"])
    p = population(geometry, gen, traffic["slots"], traffic["alive"], traffic["sigma"],
                   config["sh_degree"], device)
    mu = {g: torch.zeros_like(p[g]) for g in reference.GROUPS}
    nu = {g: torch.zeros_like(p[g]) for g in reference.GROUPS}
    m, n = config["scan_grid"]
    grid = make_scan_grid(m, n)
    sc = scene_constants(config)
    degree = config["sh_degree"]
    with torch.no_grad(), reference.precision("fp32"):
        level = torch.stack([
            reference.histogram("sampled", p, torch.as_tensor(cam, device=device), sc, degree,
                                chunk)
            for cam in level_points(grid, m, n)]).mean(0)
    num_r = config["end"] - config["start"]
    noise = torch.rand((num_r, m * n), generator=gen, dtype=torch.float32, device=device)
    nlos = torch.zeros((config["end"], m * n), dtype=torch.float32, device=device)
    nlos[config["start"]:] = level[:, None] * (0.5 + noise) / GT_TIMES
    rng = program_seed(seed)
    return dict(params=p, mu=mu, nu=nu, count=traffic["start_step"] - 1,
                step=traffic["start_step"], sh_degree=degree, grid=grid,
                order=scan_order(rng, m, n, traffic["max_steps"]),
                targets=nlos.reshape(config["end"], m, n), rng=rng, target_level=level)


def step_inputs(inp: dict, config: dict, first: int, count: int):
    """(cams (count, 3), targets (count, num_r)) of steps first .. first +
    count - 1 of the scan order, as tensors on the targets' device, the
    targets times gt_times (what the loss compares)."""
    dev = inp["targets"].device
    idx = inp["order"][first:first + count]
    cams = torch.as_tensor(inp["grid"].T[idx], device=dev)
    flat = inp["targets"].reshape(config["end"], -1)[config["start"]:]
    return cams, flat[:, torch.as_tensor(idx, device=dev)].T * GT_TIMES
