"""Tools of the port: the counterparts of the JAX repo's `tools/` and of
its example scripts, and the port's own benches (`schedbench`,
`fitbench`, `dsortbench`, `occlusionbench`, `shardbench`); `kernel_work`
counts the field kernels' work and roofline bounds.

Each runs on the CUDA card by default and raises where there is none;
given `device="cpu"` (or `--cpu`) it runs the kernels' plain versions on
the CPU, whose times are those of PyTorch's CPU kernels, not of the card.
The benches that replay CUDA graphs run on the card only.

    python -m nlos_gaussian_renderer_tpu_torch.tools.microbench [--rsort] [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.cullbench [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.grad_parity [--rows ...] [--fd] [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.schedbench  (the card only: CUDA graphs)
    python -m nlos_gaussian_renderer_tpu_torch.tools.long_run [--iters N] [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.export_reconstruction --ckpt DIR
    python -m nlos_gaussian_renderer_tpu_torch.tools.reconstruct_synthetic [--renderer pallas]
    python -m nlos_gaussian_renderer_tpu_torch.tools.analytic_crossover [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.precision_compare [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.coveragestat [--cpu]
    python -m nlos_gaussian_renderer_tpu_torch.tools.scatterbench  (the card only: CUDA graphs)
    python -m nlos_gaussian_renderer_tpu_torch.tools.trace_report TRACE_DIR [--by-source]
    python -m nlos_gaussian_renderer_tpu_torch.tools.make_zaragoza_artifact --out PATH
    python -m nlos_gaussian_renderer_tpu_torch.tools.geomsweep [--points ...] [--scene ...] [--cpu]

Records go under `docs/torch/`; meshes, figures and checkpoints under
`recon_out/` (gitignored).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

# The bench scene's geometry (`bench.py:34-46`): the hidden volume, 32x32
# angles x 200 bins (bins 100..300 cover radii ~0.52..1.56 m), and the three
# probe cameras the rsort caps are tuned on (`bench.py:201-203`).
VOLUME_POSITION = np.array([0.0, 1.0, 0.0], np.float32)
VOLUME_SIZE = 0.6
C_LIGHT, DELTA_T = 1.0, 0.0052
NS, START, END = 32, 100, 300
PROBE_CAMS = np.array([[-0.4, 0, -0.4], [0, 0, 0], [0.4, 0, 0.4]], np.float32)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device raises where there is none
    (a measurement never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--cpu) to run the "
                           "plain versions on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}"
    return "cpu"


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first line), or
    'cpu (plain versions)' for a CPU run: what every record names."""
    if dev.type != "cuda":
        return "cpu (plain versions)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"{torch.cuda.get_device_name(dev)}, power limit unknown"


def chamfer_dirs(a: np.ndarray, b: np.ndarray):
    """(mean distance from each point of a to b, from each point of b to a)
    between point sets (N, 3) and (M, 3), in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1)).mean()), float(np.sqrt(d2.min(0)).mean())


def chamfer(a: np.ndarray, b: np.ndarray) -> float:
    """The symmetric Chamfer distance: the mean of `chamfer_dirs`."""
    ab, ba = chamfer_dirs(a, b)
    return (ab + ba) / 2


def write_record(path: str, record: dict) -> str:
    """Write `record` as indented JSON to `path` (its directory made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def bench_scene(gaussians=100_000, seed=0, sigma=(0.002, 0.012), device="cuda",
                max_sh_degree=0, random_pose=False):
    """(scene, box, rng): the bench scene of `bench.py`, the synthetic blob
    cluster with log-uniform sigma in `sigma` (m), drawn from
    `np.random.default_rng(seed)`, and the volume's box. `random_pose` also
    draws quaternions and higher SH bands, so every parameter group carries
    a gradient. The caller goes on drawing from the returned generator."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_ground_truth_scene
    from nlos_gaussian_renderer_tpu_torch.ops.math import volume_box_points

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    scene = make_ground_truth_scene(rng, gaussians, VOLUME_POSITION, VOLUME_SIZE,
                                    max_sh_degree=max_sh_degree, device=dev)
    log_s = rng.uniform(np.log(sigma[0]), np.log(sigma[1]),
                        (gaussians, 3)).astype(np.float32)
    with torch.no_grad():
        scene.log_scales.copy_(torch.as_tensor(log_s))
        if random_pose:
            scene.quats.copy_(torch.as_tensor(rng.normal(size=(gaussians, 4)).astype(np.float32)))
            rest = 0.1 * rng.normal(size=tuple(scene.sh_rest.shape))
            scene.sh_rest.copy_(torch.as_tensor(rest.astype(np.float32)))
    return scene, volume_box_points(VOLUME_POSITION, VOLUME_SIZE, device=dev), rng


def elapsed_ms(dev: torch.device, run) -> float:
    """Milliseconds `run()` takes: on the card, CUDA events around it and one
    synchronize after; on the CPU, the host clock."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end)
