"""Regenerate the Zaragoza-schema bunny artifact on the card: the
counterpart of the JAX repo's `examples/make_zaragoza_artifact.py`.

A procedural bunny (body, head, two ears: 600 Gaussians of sigma 13 mm,
opacity 0.85, numpy seed 0) in the 0.6 m volume at y = 1, rendered
(dense) at every point of a 64x64 scan grid into 256 bins of 2/256 m
(light travel, c = 1; bins [0.55, 1.75) m hold the signal), written as
MATLAB writes the real Zaragoza files: v5, zlib-compressed, float64,
time-first `data` (L, M, N), column vectors for the camera and volume
fields, `cameraGridPositions` (3, M*N) with column m*N + n, no 'c'.

    python -m nlos_gaussian_renderer_tpu_torch.tools.make_zaragoza_artifact \\
        --out recon_out/torch/zaragoza64_bunny.mat [--scan 64] [--bins 256] [--cpu]

It writes only where `--out` says, and refuses the committed
`examples/data/zaragoza64_bunny.mat`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import card_name, resolve_device

COMMITTED = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "examples",
                                          "data", "zaragoza64_bunny.mat"))
VOLUME_POSITION = np.array([0.0, 1.0, 0.0])
VOLUME_SIZE, C = 0.6, 1.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bunny_points(rng: np.random.Generator, n: int, center: np.ndarray,
                 size: float) -> np.ndarray:
    """Procedural bunny-ish blob cluster: body, head, two ears (z = up)."""
    s = size

    def ball(c, radii, k):
        pts = rng.normal(size=(k, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        pts *= rng.uniform(0.2, 1.0, (k, 1)) ** (1 / 3)
        return c + pts * radii

    parts = [
        ball(center + s * np.array([0.0, 0.02, -0.08]),
             s * np.array([0.22, 0.18, 0.20]), int(0.55 * n)),  # body
        ball(center + s * np.array([0.0, -0.10, 0.22]),
             s * np.array([0.13, 0.11, 0.12]), int(0.25 * n)),  # head
        ball(center + s * np.array([-0.09, -0.08, 0.42]),
             s * np.array([0.035, 0.03, 0.14]), int(0.10 * n)),  # ear L
        ball(center + s * np.array([0.09, -0.08, 0.42]),
             s * np.array([0.035, 0.03, 0.14]),
             n - int(0.55 * n) - int(0.25 * n) - int(0.10 * n)),  # ear R
    ]
    return np.concatenate(parts, axis=0)


def window(bins: int):
    """(deltaT, start, end): 2 m of light travel over `bins`, the signal in
    [0.55, 1.75) m."""
    delta_t = 2.0 / bins
    return delta_t, int(0.55 / delta_t), min(int(1.75 / delta_t), bins)


def bunny_scene(seed: int = 0, device=None):
    """The artifact's hidden scene, from `default_rng(seed)`."""
    from nlos_gaussian_renderer_tpu_torch.models.scene import init_scene
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

    rng = np.random.default_rng(seed)
    pts = bunny_points(rng, 600, VOLUME_POSITION, VOLUME_SIZE)
    rho = rng.uniform(0.55, 0.95, (pts.shape[0], 1))
    scene = init_scene(pts.astype(np.float32), rho.astype(np.float32),
                       pmin=VOLUME_POSITION - VOLUME_SIZE / 2,
                       pmax=VOLUME_POSITION + VOLUME_SIZE / 2,
                       max_sh_degree=0, knn_scale_init=False, device=device)
    with torch.no_grad():
        scene.log_scales.fill_(float(np.float32(np.log(0.013))))
        scene.logit_opacities.fill_(
            float(gmath.inverse_sigmoid(torch.tensor(0.85, dtype=torch.float32))))
    return scene


def render_points(scene, cams: np.ndarray, bins: int, ns: int, chunk: int = 32) -> np.ndarray:
    """(P, end - start) dense histograms at the (P, 3) scan positions."""
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.render import (
        RenderSettings,
        render_histogram_batch,
    )

    dev = scene.means.device
    delta_t, start, end = window(bins)
    box = gmath.volume_box_points(VOLUME_POSITION.astype(np.float32), VOLUME_SIZE, device=dev)
    vol = torch.as_tensor(VOLUME_POSITION.astype(np.float32), device=dev)
    settings = RenderSettings(num_sampling_points=ns, start=start, end=end)
    cams_t = torch.as_tensor(np.asarray(cams, np.float32), device=dev)
    with torch.no_grad():
        return np.concatenate([
            render_histogram_batch(scene, cams_t[i:i + chunk], box, C, delta_t, vol, 0,
                                   settings).cpu().numpy()
            for i in range(0, cams_t.shape[0], chunk)
        ])


def build_dataset(scan: int, bins: int, ns: int, seed: int = 0, device=None):
    """(NLOSData, scene): the artifact's dataset rendered on `device`."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid
    from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData

    scene = bunny_scene(seed, device)
    cam_grid = make_scan_grid(scan, scan)
    hists = render_points(scene, cam_grid.T, bins, ns)  # (MN, end - start)
    delta_t, start, end = window(bins)
    nlos = np.zeros((bins, scan, scan))
    nlos[start:end] = hists.T.reshape(end - start, scan, scan)
    return NLOSData(
        nlos_data=nlos,
        camera_position=np.array([0.0, -0.5, 0.0]),
        camera_grid_size=np.array([0.8, 0.8]),
        camera_grid_positions=cam_grid.astype(np.float64),
        camera_grid_points=np.array([scan, scan]),
        volume_position=VOLUME_POSITION,
        volume_size=VOLUME_SIZE,
        deltaT=delta_t,
        c=C,
    ), scene


def write_matlab_style(path: str, data) -> None:
    """Write with MATLAB-native shapes and dtypes (see the module's
    docstring)."""
    import scipy.io as sio

    f64 = np.float64
    sio.savemat(
        path,
        {
            "data": data.nlos_data.astype(f64),
            "cameraPosition": data.camera_position.reshape(3, 1).astype(f64),
            "cameraGridSize": data.camera_grid_size.reshape(2, 1).astype(f64),
            "cameraGridPositions": data.camera_grid_positions.astype(f64),
            "cameraGridPoints": data.camera_grid_points.reshape(1, 2).astype(f64),
            "hiddenVolumePosition": data.volume_position.reshape(3, 1).astype(f64),
            "hiddenVolumeSize": np.array([[data.volume_size]], dtype=f64),
            "deltaT": np.array([[data.deltaT]], dtype=f64),
            # no 'c': the dataset files do not carry it; loaders default to 1.
        },
        do_compression=True,
    )


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", type=int, default=64)
    ap.add_argument("--bins", type=int, default=256)
    ap.add_argument("--ns", type=int, default=16)
    ap.add_argument("--out", required=True, help="the .mat to write")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = ap.parse_args(argv)
    if os.path.normpath(os.path.abspath(args.out)) == COMMITTED:
        raise ValueError(f"{args.out} is the committed artifact: write elsewhere")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    data, _ = build_dataset(args.scan, args.bins, args.ns, device=dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_matlab_style(args.out, data)
    log(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB), data shape "
        f"{data.nlos_data.shape}, deltaT={data.deltaT}, rendered on {card_name(dev)}")
    return args.out


if __name__ == "__main__":
    main()
