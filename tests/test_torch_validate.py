"""PyTorch port vs the JAX package: the physical validation of a dataset
(`data/validate.py`) and the CLI's validate mode.

JAX's `tests/test_validate.py` on the port, and on each corruption the
port's report equals JAX's: `ok` and every error, warning and info line,
word for word. Data: JAX's synthetic capture (8x8 scan, 128 bins), carried
to the port's `NLOSData` exactly."""

import dataclasses

import numpy as np
import pytest

from nlos_gaussian_renderer_tpu.data import validate as jvalidate
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu_torch.data.validate import (
    diagnose,
    first_bounce_bins,
    validate,
)
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData


@pytest.fixture(scope="module")
def clean_data():
    jd = make_synthetic_dataset(seed=3, scan_m=8, scan_n=8, num_bins=128, num_gt_gaussians=16,
                                num_sampling_points=8)
    return NLOSData(**vars(jd))


def stretched(d):
    l, m, n = d.nlos_data.shape
    s = np.zeros((2 * l, m, n), np.float32)
    s[::2] = d.nlos_data
    return s[: int(1.8 * l)]


def normalized(d):
    td = d.nlos_data.copy()
    px_max = td.max(axis=0, keepdims=True)
    return np.where(px_max > 0, td / np.maximum(px_max, 1e-30), td)


def with_nan(d):
    td = d.nlos_data.copy()
    td[3, 1, 1] = np.nan
    return td


CORRUPTIONS = {
    "clean": lambda d: {},
    "time_axis_not_first": lambda d: dict(nlos_data=np.transpose(d.nlos_data, (1, 0, 2))),
    "grid_points": lambda d: dict(camera_grid_points=np.array([4, 16], np.int32)),
    "round_trip_bins": lambda d: dict(nlos_data=stretched(d)),
    "deltat_units": lambda d: dict(deltaT=4e-12),
    "zero": lambda d: dict(nlos_data=np.zeros_like(d.nlos_data)),
    "nan": lambda d: dict(nlos_data=with_nan(d)),
    "normalized": lambda d: dict(nlos_data=normalized(d)),
    "shuffled_grid": lambda d: dict(camera_grid_positions=d.camera_grid_positions[
        :, np.random.default_rng(0).permutation(d.camera_grid_positions.shape[1])]),
}


def corrupt(d, name):
    return dataclasses.replace(d, **CORRUPTIONS[name](d))


class TestCleanPasses:
    def test_clean_synthetic_ok(self, clean_data):
        report = diagnose(clean_data)
        assert report.ok, str(report)

    def test_validate_returns_report(self, clean_data):
        assert validate(clean_data).ok

    def test_first_bounce_tracks_geometry(self, clean_data):
        fb = first_bounce_bins(clean_data.nlos_data)
        cgp = clean_data.camera_grid_positions
        vol = clean_data.volume_position
        cdt = clean_data.c * clean_data.deltaT
        near = np.linalg.norm(cgp.T - vol[None, :], axis=1) - (
            clean_data.volume_size * np.sqrt(3) / 2)
        lit = np.isfinite(fb.reshape(-1))
        assert lit.mean() > 0.5
        assert np.all(fb.reshape(-1)[lit] * cdt >= near[lit] - 3 * cdt)


class TestCorruptionsCaught:
    def test_time_axis_not_first(self, clean_data):
        assert not diagnose(corrupt(clean_data, "time_axis_not_first")).ok

    def test_scan_axes_swapped_against_grid_points(self, clean_data):
        report = diagnose(corrupt(clean_data, "grid_points"))
        assert not report.ok
        assert any("cameraGridPoints" in e for e in report.errors)

    def test_roundtrip_time_bins(self, clean_data):
        report = diagnose(corrupt(clean_data, "round_trip_bins"))
        assert not report.ok
        assert any("ROUND-TRIP" in e for e in report.errors), str(report)

    def test_wrong_deltat_units(self, clean_data):
        assert not diagnose(corrupt(clean_data, "deltat_units")).ok

    def test_zero_transient(self, clean_data):
        assert not diagnose(corrupt(clean_data, "zero")).ok

    def test_nan_transient(self, clean_data):
        assert not diagnose(corrupt(clean_data, "nan")).ok

    def test_validate_raises(self, clean_data):
        with pytest.raises(ValueError, match="failed validation"):
            validate(corrupt(clean_data, "zero"))


class TestWarnings:
    def test_per_pixel_normalization_warns(self, clean_data):
        report = diagnose(corrupt(clean_data, "normalized"))
        assert any("normalization" in w for w in report.warnings), str(report)

    def test_shuffled_grid_positions_flagged(self, clean_data):
        report = diagnose(corrupt(clean_data, "shuffled_grid"))
        assert not report.ok or any("row-major" in w for w in report.warnings), str(report)


class TestCLIValidateMode:
    def test_cli_validate_mode(self, tmp_path, clean_data, capsys):
        from nlos_gaussian_renderer_tpu_torch.cli import main
        from nlos_gaussian_renderer_tpu_torch.data.zaragoza import save_zaragoza_mat

        path = tmp_path / "ok.mat"
        save_zaragoza_mat(str(path), clean_data)
        main(["--mode", "validate", "--datadir", str(path)])
        out = capsys.readouterr().out
        assert "dataset OK" in out
        assert "schema of" in out

    def test_cli_validate_mode_fails_on_corrupt(self, tmp_path, clean_data):
        from nlos_gaussian_renderer_tpu_torch.cli import main
        from nlos_gaussian_renderer_tpu_torch.data.zaragoza import save_zaragoza_mat

        path = tmp_path / "bad.mat"
        save_zaragoza_mat(str(path), corrupt(clean_data, "time_axis_not_first"))
        with pytest.raises(SystemExit):
            main(["--mode", "validate", "--datadir", str(path)])


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_report_equals_jax(clean_data, name):
    from nlos_gaussian_renderer_tpu.data.zaragoza import NLOSData as JData

    d = corrupt(clean_data, name)
    got = diagnose(d)
    want = jvalidate.diagnose(JData(**vars(d)))
    assert got.ok == want.ok
    assert (got.errors, got.warnings, got.info) == (want.errors, want.warnings, want.info)
    assert str(got) == str(want)
