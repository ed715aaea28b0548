"""How much of the work the field kernels schedule is useful? The
counterpart of the JAX repo's `tools/coveragestat.py`, on the port's work
units.

At the bench scene (100k Gaussians, sigma 2-12 mm, numpy seed 0) and JAX's
camera [0.1, 0, -0.2] (32x32 angles x bins 100..300, 8x16-ray tiles,
t_chunk 64), the scheduled (row, ray, bin) pairs of the forward list split
into three slack factors:

  1. block membership: block rows whose rect word does not hold the item's
     tile (K3 computes them and zeroes them);
  2. angular: a member touches the 8x16 tile, but its footprint covers only
     part of the tile's theta rows and phi columns;
  3. radial: the item's bin range (the union over the block's members) is
     wider than each member's own bin interval.

The scheduled work is the port's, from K1/K2's lists (`RSortTiles.fwd`,
`n_items`): an item covers exactly its bins [bl, bh], where JAX's rounds
them out to `gate_bins` (which changes nothing in the port). The caps come
from `tune_rsort_spec` at the camera, not JAX's fixed w_max 32768 /
max_groups 64. The useful pairs, each member row's rays times its own bins
(JAX's per-row intervals, floor / ceil of d -+ radius), are a property of
the footprints alone, as JAX counts them; `useful_pairs_in_items` is the
part of them inside the items' bin ranges, from which the radial factor is
taken. The useful pairs are counted from footprints computed on the
host, so the count is the same whichever device culled.

    python -m nlos_gaussian_renderer_tpu_torch.tools.coveragestat [--gaussians N] [--cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    VOLUME_POSITION,
    VOLUME_SIZE,
    bench_scene,
    card_name,
    device_name,
    resolve_device,
)

CAMERA = (0.1, 0.0, -0.2)
NS, START, END = 32, 100, 300


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--t-theta", type=int, default=8)
    ap.add_argument("--t-phi", type=int, default=16)
    ap.add_argument("--t-chunk", type=int, default=64)
    ap.add_argument("--sigma-min", type=float, default=0.002)
    ap.add_argument("--sigma-max", type=float, default=0.012)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def row_geometry(means, scales, alive, cam, theta, phi, r, spec):
    """Per-Gaussian footprint geometry as JAX's tool computes it, numpy:
    (in_window, the tile rows / columns of the cull footprint (G, n_tt) /
    (G, n_pt), bin interval lo / hi (floor / ceil of d -+ radius, clipped to
    the grid), rays covered along theta (G, ns) and phi (G, ns))."""
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.fused import angular_footprints

    d, radius, m_th, m_ph, in_win = angular_footprints(means, scales, alive, cam, theta, phi,
                                                       r, spec)
    d, radius, in_win = d.cpu().numpy(), radius.cpu().numpy(), in_win.cpu().numpy()
    m_th, m_ph = m_th.cpu().numpy(), m_ph.cpu().numpy()
    rv = r.cpu().numpy()
    num_r, dr = rv.shape[0], float(rv[1] - rv[0])
    lo_bin = np.clip(np.floor((d - radius - rv[0]) / dr), 0, num_r - 1)
    hi_bin = np.clip(np.ceil((d + radius - rv[0]) / dr), 0, num_r - 1)
    sph = gmath.cartesian_to_spherical(means - cam[None, :]).cpu().numpy()
    alpha = np.arcsin(np.clip(radius / d, -1, 1))
    th_lo, th_hi = sph[:, 1] - alpha, sph[:, 1] + alpha
    sin_min = np.maximum(np.minimum(np.sin(np.clip(th_lo, 0, np.pi)),
                                    np.sin(np.clip(th_hi, 0, np.pi))), 1e-3)
    dphi = np.arcsin(np.clip(radius / (d * sin_min), -1, 1))
    th_v, ph_v = theta.cpu().numpy(), phi.cpu().numpy()
    th_cov = (th_v[None, :] >= th_lo[:, None]) & (th_v[None, :] <= th_hi[:, None])
    ph_cov = ((ph_v[None, :] >= (sph[:, 2] - dphi)[:, None])
              & (ph_v[None, :] <= (sph[:, 2] + dphi)[:, None]))
    return in_win, m_th, m_ph, lo_bin, hi_bin, th_cov, ph_cov


def coverage(scene, cam, box_points, spec, ns: int = NS, start: int = START,
             end: int = END) -> dict:
    """The pair counts and slack factors of one camera's forward list."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import decode_rect_members, rsort_cull
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    cam = torch.as_tensor(np.asarray(cam, np.float32), device=scene.means.device)
    grid = shell_grid(cam, box_points, ns, start, end, C_LIGHT, DELTA_T)
    with torch.no_grad():
        tiles = rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                           grid.phi, grid.r, spec)
    if bool(tiles.overflowed):
        raise RuntimeError(f"the work list overflowed at w_max {spec.w_max}")
    w = int(tiles.n_items[0])
    ft, fj, fb, _, fbl, fbh = (x.cpu().numpy().astype(np.int64) for x in tiles.fwd[:, :w])
    n_tt, n_pt = -(-ns // spec.t_theta), -(-ns // spec.t_phi)
    s_ang = spec.t_theta * spec.t_phi
    memb = decode_rect_members(tiles.words[:, 0], n_tt, n_pt).cpu().numpy()
    full_perm = tiles.full_perm.cpu().numpy()
    # The footprints on the host, from the scene's stored parameters (the
    # scales exponentiated there too: the card's exp may differ in the last
    # bit): the useful pairs do not depend on the device that culled.
    with torch.no_grad():
        host = [t.detach().cpu() for t in (scene.means, scene.log_scales, scene.alive, cam,
                                           box_points)]
        host[1] = torch.exp(host[1])
        g_h = shell_grid(host[3], host[4], ns, start, end, C_LIGHT, DELTA_T)
        in_win, m_th, m_ph, lo_bin, hi_bin, th_cov, ph_cov = row_geometry(
            *host[:4], g_h.theta, g_h.phi, g_h.r, spec)
    valid = (full_perm >= 0) & (full_perm < scene.means.shape[0])
    rows = np.where(valid, full_perm, 0)
    in_r = in_win[rows] & valid
    lo_r, hi_r = lo_bin[rows], hi_bin[rows]
    th_r, ph_r = th_cov[rows], ph_cov[rows]

    nb = fbh - fbl + 1  # an item's bins
    scheduled = float(nb.sum()) * spec.g_tile * s_ang
    member = angular = in_items = 0.0
    for i in range(w):
        blk = slice(fb[i] * spec.g_tile, (fb[i] + 1) * spec.g_tile)
        mem = memb[blk, ft[i]] & in_r[blk]
        member += float(mem.sum()) * s_ang * nb[i]
        if not mem.any():
            continue
        tt, pt = divmod(int(ft[i]), n_pt)
        rays = (th_r[blk][:, tt * spec.t_theta:(tt + 1) * spec.t_theta].sum(1)
                * ph_r[blk][:, pt * spec.t_phi:(pt + 1) * spec.t_phi].sum(1))
        angular += float((mem * rays).sum()) * nb[i]
        ch0 = fj[i] * spec.t_chunk
        blo = np.maximum(lo_r[blk] - ch0, fbl[i])
        bhi = np.minimum(hi_r[blk] - ch0, fbh[i])
        in_items += float((mem * rays * np.maximum(bhi - blo + 1, 0)).sum())

    # Useful pairs from the host's footprints alone: every (Gaussian, tile
    # of its cull footprint) once.
    tt_all, pt_all = np.divmod(np.arange(n_tt * n_pt), n_pt)
    th_t = np.stack([th_cov[:, a * spec.t_theta:(a + 1) * spec.t_theta].sum(1)
                     for a in range(n_tt)], 1)  # (G, n_tt)
    ph_t = np.stack([ph_cov[:, b * spec.t_phi:(b + 1) * spec.t_phi].sum(1)
                     for b in range(n_pt)], 1)
    member_t = m_th[:, tt_all] & m_ph[:, pt_all] & in_win[:, None]  # (G, T)
    bins = np.maximum(hi_bin - lo_bin + 1, 0)
    useful = float((member_t * th_t[:, tt_all] * ph_t[:, pt_all] * bins[:, None]).sum())
    return {
        "items": w,
        "w_max": spec.w_max, "max_groups": spec.max_groups, "t_chunk": spec.t_chunk,
        "scheduled_pairs": scheduled,
        "member_pairs": member,
        "angular_pairs": angular,
        "useful_pairs": useful,
        "useful_pairs_in_items": in_items,
        "block_membership_slack": scheduled / max(member, 1.0),
        "angular_slack": member / max(angular, 1.0),
        "radial_slack": angular / max(in_items, 1.0),
        "over_coverage": scheduled / max(in_items, 1.0),
    }


def run(args) -> dict:
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec, tune_rsort_spec

    dev = resolve_device("cpu" if args.cpu else "cuda")
    scene, box, _ = bench_scene(args.gaussians, seed=0, sigma=(args.sigma_min, args.sigma_max),
                                device=dev)
    base = RSortSpec(t_theta=args.t_theta, t_phi=args.t_phi, t_chunk=args.t_chunk,
                     gate_bins=8)
    spec = tune_rsort_spec(scene, np.asarray([CAMERA], np.float32), box, NS, START, END,
                           C_LIGHT, DELTA_T, base=base)
    out = coverage(scene, CAMERA, box, spec)
    out.update(gaussians=args.gaussians, camera=list(CAMERA),
               volume=[*map(float, VOLUME_POSITION), VOLUME_SIZE],
               platform=device_name(dev), card=card_name(dev))
    return out


def main(argv=None) -> dict:
    out = run(build_argparser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
