"""Times the non-kernel pieces of the `pallas_rsort` step on the card.

Port of `tools/cullbench.py`. At the bench scene (100k Gaussians, numpy
seed 0, sigma 2-12 mm, 32x32 angles x 200 bins, t_chunk 32, caps tuned on
the three probe cameras), each piece is timed over 30 calls that walk 64
random scan points:

  1. `cull_only`: shell grid + `rsort_cull` (footprints, sort, layout, work
     lists through K1/K2);
  2. `footprints_only`: shell grid + `angular_footprints`;
  3. `tiling_only`: shell grid + `tile_points_centered_direct_t` (32 x 200
     samples, TileSpec(8, 16, 32)), the tiling the step runs. JAX's tool
     times `tile_points_centered` and a bf16 hi/lo split, which its own step
     does not run either; the port computes the forms in f32;
  4. `quadform_only`: the Gaussians' quadratic forms.

Nothing runs at import. `run()` returns {name: ms} and the count of culls
that overflowed their capacities.

    python -m nlos_gaussian_renderer_tpu_torch.tools.cullbench [--cpu] [--gaussians N]
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    PROBE_CAMS,
    START,
    bench_scene,
    device_name,
    elapsed_ms,
    resolve_device,
)


class Bench(NamedTuple):
    scene: object
    box: torch.Tensor
    spec: object
    cams: torch.Tensor  # (64, 3) random scan points on the wall


def setup(gaussians=100_000, device="cuda") -> Bench:
    """The bench scene, its tuned caps and the 64 cameras, drawn from one
    numpy generator in the JAX tool's order."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec, tune_rsort_spec

    dev = resolve_device(device)
    scene, box, rng = bench_scene(gaussians, device=dev)
    spec = tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                           base=RSortSpec(t_chunk=32))
    print(f"spec: w_max={spec.w_max} groups={spec.max_groups}", file=sys.stderr)
    cams = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32) * np.float32([1, 0, 1])
    return Bench(scene, box, spec, torch.as_tensor(cams, device=dev))


def _grid(b: Bench, i: int):
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    return shell_grid(b.cams[i], b.box, NS, START, END, C_LIGHT, DELTA_T)


@torch.no_grad()
def cull_only(b: Bench, i: int):
    """Small summaries of one cull (sums of the permutation, the forward
    tile list and the words; the overflow flag; the item count)."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import rsort_cull

    g = _grid(b, i)
    s = b.scene
    t = rsort_cull(s.means, s.scales, s.alive, b.cams[i], g.theta, g.phi, g.r, b.spec)
    return (torch.sum(t.full_perm), torch.sum(t.fwd_t), t.overflowed,
            torch.sum(t.words), t.n_items)


@torch.no_grad()
def footprints_only(b: Bench, i: int):
    from nlos_gaussian_renderer_tpu_torch.ops.fused import angular_footprints

    g = _grid(b, i)
    s = b.scene
    d, _, m_th, m_ph, in_w = angular_footprints(s.means, s.scales, s.alive, b.cams[i],
                                                g.theta, g.phi, g.r, b.spec)
    return torch.sum(d), torch.sum(m_th), torch.sum(m_ph), torch.sum(in_w)


@torch.no_grad()
def tiling_only(b: Bench, i: int):
    from nlos_gaussian_renderer_tpu_torch.ops.fused import (
        TileSpec,
        tile_points_centered_direct_t,
    )

    g = _grid(b, i)
    xfeat, centers = tile_points_centered_direct_t(
        g.theta, g.phi, g.r, b.cams[i], TileSpec(t_theta=8, t_phi=16, t_r=32), 4, 2, 7)
    return torch.sum(xfeat), torch.sum(centers)


@torch.no_grad()
def quadform_only(b: Bench, i: int):
    return torch.sum(b.scene.quadratic_form(1.0) * b.cams[i, 0])


FUNCTIONS = (("cull_only", cull_only), ("footprints_only", footprints_only),
             ("tiling_only", tiling_only), ("quadform_only", quadform_only))


def timeit(b: Bench, fn, n=30):
    """(ms per call over calls i = 0 .. n-1 on camera i % 64, after two
    warm-up calls; the outputs)."""
    fn(b, 0)
    fn(b, 1)
    outs = []
    ms = elapsed_ms(b.cams.device, lambda: outs.extend(fn(b, i % 64) for i in range(n)))
    return ms / n, outs


def run(gaussians=100_000, device="cuda", n=30):
    """{name: ms per call} of the four pieces, and the number of timed culls
    whose work list or groups overflowed."""
    b = setup(gaussians, device)
    times, overflows = {}, 0
    for name, fn in FUNCTIONS:
        ms, outs = timeit(b, fn, n)
        times[name] = ms
        if fn is cull_only:
            overflows = int(sum(bool(o[2]) for o in outs))
        note = ("  (the step's tiling; JAX's bf16 hi/lo split: no counterpart, f32)"
                if fn is tiling_only else "")
        print(f"{name}: {ms:7.3f} ms{note}")
    print(f"culls that overflowed: {overflows} of {n}")
    return times, overflows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device_name(dev)}", file=sys.stderr)
    return run(args.gaussians, dev)


if __name__ == "__main__":
    main()
