"""Stanford-style confocal capture loader (O'Toole et al. LCT datasets).

A copy of `nlos_gaussian_renderer_tpu/data/stanford.py` (numpy and scipy
only) on the port's `NLOSData`: one .mat file gives the same arrays in both
packages.

The reference only ships a (missing) Zaragoza loader; real confocal captures
(statue/bike etc.) use a different .mat schema. This converts them to the
same `NLOSData` container:

  - 'meas' (or 'measlr'/'rect_data'): measurement volume. Accepted layouts:
    (T, M, N) or (M, N, T) — detected by which axis is the largest (time bins
    greatly exceed the scan resolution in these captures).
  - 'tofgrid' (optional): per-pixel time-of-flight offsets in ps used to
    pre-align the direct bounce; subtracted by the standard preprocessing.
  - wall extent and bin width are capture metadata, not stored uniformly in
    the files, so they are explicit arguments (defaults follow the public
    captures: 2 m wall, 32 ps bins, c = 3e8 m/s; distances normalized to
    c = 1 units like the Zaragoza pipeline).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData

C_M_PER_S = 2.99792458e8


def align_direct_bounce(
    meas: np.ndarray, tofgrid: np.ndarray, bin_ps: float
) -> np.ndarray:
    """Shift each pixel's histogram so bin 0 is the wall's direct bounce.

    Stanford captures ship a per-pixel 'tofgrid' (picoseconds to the wall
    point and back); the standard LCT preprocessing left-shifts each pixel's
    time axis by round(tofgrid / bin_ps) bins so all pixels share a time
    origin at the wall. Vacated tail bins are zero-filled (the captures carry
    no signal there).

    Args:
      meas: (T, M, N) time-first measurement volume.
      tofgrid: (M, N) per-pixel time of flight in picoseconds.
      bin_ps: time-bin width in picoseconds.
    Returns:
      (T, M, N) aligned volume.
    """
    t = meas.shape[0]
    if tofgrid.shape != meas.shape[1:]:
        raise ValueError(
            f"tofgrid shape {tofgrid.shape} != scan grid {meas.shape[1:]}"
        )
    shifts = np.round(np.asarray(tofgrid, np.float64) / bin_ps).astype(np.int64)
    idx = np.arange(t)[:, None, None] + shifts[None, :, :]  # (T, M, N)
    valid = idx < t
    gathered = np.take_along_axis(meas, np.clip(idx, 0, t - 1), axis=0)
    return np.where(valid, gathered, 0.0).astype(meas.dtype)


def load_stanford_data(
    path: str,
    wall_size: float = 2.0,
    bin_ps: float = 32.0,
    volume_distance: Optional[float] = None,
    volume_size: Optional[float] = None,
    downsample_t: int = 1,
    crop_t: Optional[int] = None,
    use_tofgrid: bool = True,
) -> NLOSData:
    """Load a Stanford-style confocal .mat into NLOSData (c = 1 units).

    Args:
      path: .mat file with a 'meas'-like volume.
      wall_size: physical scan extent on the wall (meters).
      bin_ps: time-bin width (picoseconds).
      volume_distance: hidden-volume standoff from the wall (meters);
        default wall_size / 2.
      volume_size: hidden-volume edge length; default wall_size / 2.
      downsample_t: integrate groups of this many time bins.
      crop_t: keep only the first crop_t bins (after downsampling).
      use_tofgrid: when the file carries a 'tofgrid', pre-align the direct
        bounce (see `align_direct_bounce`).
    """
    import scipy.io as sio

    mat = sio.loadmat(path)
    meas = None
    for key in ("meas", "measlr", "rect_data", "data"):
        if key in mat:
            meas = np.asarray(mat[key], dtype=np.float32)
            break
    if meas is None:
        raise KeyError(
            "no measurement volume found (tried meas/measlr/rect_data/data)"
        )
    if meas.ndim != 3:
        raise ValueError(f"expected 3D measurement, got {meas.shape}")

    # Put time first: the time axis dominates in length.
    t_axis = int(np.argmax(meas.shape))
    meas = np.moveaxis(meas, t_axis, 0)  # (T, M, N)

    if use_tofgrid and "tofgrid" in mat:
        meas = align_direct_bounce(
            meas, np.asarray(mat["tofgrid"], np.float64), bin_ps
        )

    if downsample_t > 1:
        t = (meas.shape[0] // downsample_t) * downsample_t
        meas = meas[:t].reshape(-1, downsample_t, *meas.shape[1:]).sum(1)
    if crop_t is not None:
        meas = meas[:crop_t]

    t_bins, m, n = meas.shape
    # Bin width in meters of light travel; with c = 1 units deltaT is meters.
    delta_t = bin_ps * 1e-12 * C_M_PER_S * downsample_t
    vol_dist = wall_size / 2 if volume_distance is None else volume_distance
    vol_size = wall_size / 2 if volume_size is None else volume_size

    xs = np.linspace(-wall_size / 2, wall_size / 2, m)
    zs = np.linspace(-wall_size / 2, wall_size / 2, n)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    cam_grid = np.stack(
        [xx.ravel(), np.zeros(m * n), zz.ravel()], axis=0
    ).astype(np.float32)

    return NLOSData(
        nlos_data=meas,
        camera_position=np.zeros(3, np.float32),
        camera_grid_size=np.array([wall_size, wall_size], np.float32),
        camera_grid_positions=cam_grid,
        camera_grid_points=np.array([m, n], np.int32),
        volume_position=np.array([0.0, vol_dist, 0.0], np.float32),
        volume_size=float(vol_size),
        deltaT=float(delta_t),
        c=1.0,
    )
