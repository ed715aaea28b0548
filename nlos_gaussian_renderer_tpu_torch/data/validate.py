"""Defense-in-depth validation of a loaded confocal dataset.

A copy of `nlos_gaussian_renderer_tpu/data/validate.py` (numpy and scipy
only; the port never imports the JAX package) on the port's `NLOSData`:
the same dataset gives the same report, word for word.

The reference's data loader is absent from its repo (`data/` gitignored;
call site: the reference's `main.py:93`), so this framework's Zaragoza schema
is a reconstruction — a real capture could disagree in exactly the ways that
never crash: permuted axes, per-pixel normalization, wrong time units. This
module diagnoses those *physically*: the one thing a confocal transient
cannot hide is that photons at time bin t traveled distance t*c*deltaT, so
the first-bounce bin of every scan point must track its geometric distance
to the hidden volume (bin->radius convention: `ops/sampling.shell_grid`,
r = bin * c * deltaT).

Use `diagnose(data)` for the report dict, `validate(data)` to raise on
errors, or the CLI: `python -m nlos_gaussian_renderer_tpu_torch.cli
--mode validate --datadir file.mat`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData


@dataclasses.dataclass
class ValidationReport:
    """Outcome of `diagnose`. `errors` mean the pipeline WILL mis-train;
    `warnings` flag suspicious-but-survivable properties."""

    errors: List[str]
    warnings: List[str]
    info: List[str]

    @property
    def ok(self) -> bool:
        return not self.errors

    def __str__(self) -> str:
        lines = []
        for tag, items in (
            ("ERROR", self.errors), ("WARN", self.warnings),
            ("info", self.info),
        ):
            lines += [f"[{tag}] {s}" for s in items]
        return "\n".join(lines) if lines else "[info] no findings"


def first_bounce_bins(
    nlos_data: np.ndarray, threshold_frac: float = 0.05
) -> np.ndarray:
    """(M, N) index of the first time bin above threshold_frac * per-pixel
    max (np.inf where a scan point never crosses it)."""
    l = nlos_data.shape[0]
    flat = nlos_data.reshape(l, -1)
    thresh = flat.max(axis=0) * threshold_frac
    above = flat >= np.maximum(thresh[None, :], 1e-30)
    has = above.any(axis=0)
    first = np.where(has, above.argmax(axis=0), np.inf)
    return first.reshape(nlos_data.shape[1:])


def diagnose(
    data: NLOSData, threshold_frac: float = 0.05
) -> ValidationReport:
    """Physical-consistency diagnosis of a confocal dataset.

    Checks (each cites the consuming code that breaks when it fails):
      1. Finiteness / nonnegativity of the transient.
      2. Shape consistency: nlos_data is (L, M, N) with (M, N) ==
         cameraGridPoints and M*N == cameraGridPositions columns — and L is
         NOT merely misplaced (axis permutation detection).
      3. Scan grid geometry: positions lie on the visible wall (a plane),
         with extent ~ cameraGridSize (`train.gather_batch` indexes columns
         as (m*N + n); a transposed grid silently pairs histograms with the
         wrong positions).
      4. Time-axis physics: per-scan-point first-bounce bin vs the geometric
         bin range [dist_to_nearest_volume_point, dist_to_farthest] /
         (c*deltaT) (`shell_grid` maps bin -> r = bin*c*deltaT). Catches
         wrong deltaT units (ps vs s), round-trip-vs-one-way time, and
         permuted layouts that survive the shape check.
      5. Normalization fingerprints: identical per-pixel maxima suggest
         per-pixel normalization, which destroys the relative radiometry
         the sin(theta)/r^2 model expects (`ops/sampling.attenuation_weights`).
    """
    errors: List[str] = []
    warnings: List[str] = []
    info: List[str] = []

    td = np.asarray(data.nlos_data)
    if td.ndim != 3:
        errors.append(f"nlos_data must be 3-D (L, M, N); got shape {td.shape}")
        return ValidationReport(errors, warnings, info)
    l, m, n = td.shape
    info.append(f"nlos_data shape (L, M, N) = {(l, m, n)}")

    # 1 — values.
    n_bad = int(np.size(td) - np.isfinite(td).sum())
    if n_bad:
        errors.append(f"{n_bad} non-finite transient values")
    neg_frac = float((td < 0).mean())
    if neg_frac > 0.01:
        warnings.append(
            f"{neg_frac:.1%} negative photon counts (background-subtracted "
            "capture? the MSE loss tolerates it; space carving may not)"
        )
    if not np.any(td > 0):
        errors.append("transient is identically zero")
        return ValidationReport(errors, warnings, info)

    # 2 — shapes & permutation.
    gp = np.asarray(data.camera_grid_points).reshape(-1)
    if gp.size >= 2 and (int(gp[0]), int(gp[1])) != (m, n):
        sorted_match = sorted(map(int, gp[:2])) == sorted((m, n))
        hint = (
            " (axes 1/2 appear SWAPPED — scan grid transposed)"
            if sorted_match else ""
        )
        errors.append(
            f"cameraGridPoints {tuple(map(int, gp[:2]))} != nlos_data scan "
            f"axes {(m, n)}{hint}"
        )
    cgp = np.asarray(data.camera_grid_positions)
    if cgp.shape != (3, m * n):
        errors.append(
            f"cameraGridPositions shape {cgp.shape} != (3, M*N) = {(3, m*n)}"
        )
        return ValidationReport(errors, warnings, info)

    # 3 — scan-plane geometry.
    spans = cgp.max(axis=1) - cgp.min(axis=1)
    flat_axis = int(np.argmin(spans))
    if spans[flat_axis] > 1e-3 * max(spans.max(), 1e-9):
        warnings.append(
            f"scan points not coplanar (axis spans {spans}); expected a "
            "wall-plane grid"
        )
    else:
        info.append(
            f"scan plane: axis {'xyz'[flat_axis]} = "
            f"{cgp[flat_axis].mean():.4g}, extent "
            f"{np.delete(spans, flat_axis)}"
        )
    gs = np.asarray(data.camera_grid_size).reshape(-1)
    if gs.size >= 2:
        extent = np.sort(np.delete(spans, flat_axis))[::-1]
        declared = np.sort(gs[:2])[::-1]
        if np.any(np.abs(extent - declared) > 0.25 * np.maximum(declared, 1e-9)):
            warnings.append(
                f"scan extent {extent} vs cameraGridSize {declared}: "
                ">25% off (units or cropping mismatch)"
            )
    # Row-major pairing check: consecutive columns of cameraGridPositions
    # must be spatial neighbors (stride = one grid step, not one row). The
    # expected step comes from the grid GEOMETRY (extent / points), never
    # from the data itself — a shuffled grid would fool its own median.
    if m > 1 and n > 1:
        d_col = np.linalg.norm(np.diff(cgp, axis=1), axis=0)
        ext = np.delete(spans, flat_axis)
        exp_step = float(ext.min()) / max(n - 1, 1)
        big = d_col > 2.0 * max(exp_step, 1e-12)
        if int(big.sum()) > m:  # row wraps account for <= m-1 jumps
            warnings.append(
                "cameraGridPositions column order is not row-major "
                f"({int(big.sum())} jumps > 2x the grid step vs <= {m - 1} "
                "expected row wraps) — scan indices will pair with wrong "
                "positions"
            )

    # 4 — time-axis physics via first bounces.
    vol = np.asarray(data.volume_position).reshape(-1)
    half = float(data.volume_size) / 2.0
    cdt = float(data.c) * float(data.deltaT)
    if cdt <= 0:
        errors.append(f"c * deltaT = {cdt} must be positive")
        return ValidationReport(errors, warnings, info)
    fb = first_bounce_bins(td, threshold_frac).reshape(-1)
    lit = np.isfinite(fb)
    if lit.mean() < 0.25:
        warnings.append(
            f"only {lit.mean():.0%} of scan points have signal above "
            f"{threshold_frac:.0%} of their max"
        )
    if lit.any():
        # Geometric bin window per scan point: nearest / farthest point of
        # the volume cube (conservative: corner radius).
        diff = np.abs(cgp.T - vol[None, :])  # (MN, 3)
        corner = np.linalg.norm(diff + half, axis=1)
        nearest = np.linalg.norm(np.maximum(diff - half, 0.0), axis=1)
        bin_lo = nearest / cdt
        bin_hi = corner / cdt
        fb_l, lo_l, hi_l = fb[lit], bin_lo[lit], bin_hi[lit]
        # Physics slack of 2 bins only: signal before bin_lo is light
        # arriving faster than geometry allows; first signal after bin_hi
        # means the whole volume stayed dark past its farthest corner.
        early = float((fb_l < lo_l - 2).mean())
        late = float((fb_l > hi_l + 2).mean())
        med_fb = float(np.median(fb_l))
        med_geo = float(np.median(lo_l))
        info.append(
            f"first-bounce bins: median {med_fb:.0f} (geometric window "
            f"medians [{med_geo:.0f}, {float(np.median(hi_l)):.0f}])"
        )
        if early + late > 0.3:
            ratio = med_fb / max(med_geo, 1e-9)
            if 1.6 < ratio < 2.5:
                hint = (
                    " — ratio ~2x: bins look like ROUND-TRIP time; this "
                    "pipeline expects one-way bins (r = bin*c*deltaT, "
                    "ops/sampling.py shell_grid)"
                )
            elif ratio > 10 or ratio < 0.1:
                hint = (
                    f" — ratio {ratio:.2g}: deltaT units likely wrong "
                    "(seconds vs bin-distance) or time axis is not axis 0"
                )
            else:
                hint = ""
            errors.append(
                f"{early + late:.0%} of lit scan points have first-bounce "
                f"bins outside their geometric window{hint}"
            )
        elif early + late > 0.05:
            warnings.append(
                f"{early + late:.0%} of lit scan points have first-bounce "
                "bins outside their geometric window (noisy capture?)"
            )
        # Spatial coherence: first-bounce bins of a real capture vary
        # smoothly across the scan grid; a (time, scan) transposition that
        # survives the square-shape check shows up as salt-and-pepper here.
        fb2 = first_bounce_bins(td, threshold_frac)
        if m > 2 and n > 2 and np.isfinite(fb2).all():
            grad = np.abs(np.diff(fb2, axis=0)).mean() + np.abs(
                np.diff(fb2, axis=1)
            ).mean()
            if grad > 0.2 * l:
                errors.append(
                    f"first-bounce bins jump {grad:.0f} bins between "
                    "neighboring scan points (smooth surface expected) — "
                    "time axis is probably not axis 0"
                )

    # 4b — window coverage.
    max_bin = l * cdt
    far_med = float(np.median(np.linalg.norm(cgp.T - vol[None, :], axis=1)))
    if max_bin < far_med:
        errors.append(
            f"time window covers radii up to {max_bin:.3g} but the volume "
            f"center is {far_med:.3g} away — deltaT/c too small or "
            "histogram truncated"
        )

    # 5 — normalization fingerprints.
    px_max = td.reshape(l, -1).max(axis=0)
    lit_max = px_max[px_max > 0]
    if lit_max.size > 4 and np.allclose(lit_max, lit_max[0], rtol=1e-5):
        warnings.append(
            f"every lit scan point peaks at exactly {lit_max[0]:.4g} — "
            "per-pixel normalization detected; relative radiometry across "
            "scan points is lost (attenuation model expects raw counts)"
        )
    return ValidationReport(errors, warnings, info)


def validate(data: NLOSData, threshold_frac: float = 0.05) -> ValidationReport:
    """`diagnose`, raising ValueError when the dataset cannot train."""
    report = diagnose(data, threshold_frac)
    if not report.ok:
        raise ValueError(
            "dataset failed validation:\n" + str(report)
        )
    return report


def print_schema(path: str) -> None:
    """Key inventory of a raw .mat file (pre-loader diagnosis)."""
    import scipy.io as sio

    mat = sio.loadmat(path)
    print(f"schema of {path}:")
    for k, v in mat.items():
        if k.startswith("__"):
            continue
        arr = np.asarray(v)
        print(f"  {k}: shape {arr.shape} dtype {arr.dtype}")
