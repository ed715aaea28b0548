"""Confocal NLOS dataset container + Zaragoza .mat loader.

A copy of `nlos_gaussian_renderer_tpu/data/zaragoza.py` (numpy and scipy
only; the port never imports the JAX package): `NLOSData`, the key aliases,
`load_zaragoza256_data` and `save_zaragoza_mat`, so one .mat file gives the
same arrays in both packages.

The reference imports `data.data_loader.load_zaragoza256_data` which is absent
from its repo (`data/` is gitignored; call site `main.py:93`). The schema is
reconstructed from the call signature and from `visualize.py:20-21` (the
transient lives under key 'data'): the loader returns
  (nlos_data[L,M,N], camera_position, camera_grid_size,
   camera_grid_positions[3,MN], camera_grid_points, volume_position[3],
   volume_size, deltaT, c).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class NLOSData:
    """A confocal transient measurement set.

    Attributes:
      nlos_data: (L, M, N) photon histogram per scan point.
      camera_position: (3,) physical camera/laser position (informational).
      camera_grid_size: (2,) physical extent of the scan grid on the wall.
      camera_grid_positions: (3, M*N) world position of each scan point.
      camera_grid_points: (2,) grid resolution (M, N).
      volume_position: (3,) hidden-volume center.
      volume_size: scalar hidden-volume edge length.
      deltaT: time-bin duration (in distance units when c == 1).
      c: light speed in dataset units.
    """

    nlos_data: np.ndarray
    camera_position: np.ndarray
    camera_grid_size: np.ndarray
    camera_grid_positions: np.ndarray
    camera_grid_points: np.ndarray
    volume_position: np.ndarray
    volume_size: float
    deltaT: float
    c: float

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.nlos_data.shape)

    def astuple(self):
        """The reference loader's 9-tuple (call site `main.py:93`)."""
        return (
            self.nlos_data,
            self.camera_position,
            self.camera_grid_size,
            self.camera_grid_positions,
            self.camera_grid_points,
            self.volume_position,
            self.volume_size,
            self.deltaT,
            self.c,
        )


_KEY_ALIASES = {
    "data": ("data", "nlos_data", "transient"),
    "cameraPosition": ("cameraPosition", "camera_position"),
    "cameraGridSize": ("cameraGridSize", "camera_grid_size"),
    "cameraGridPositions": ("cameraGridPositions", "camera_grid_positions"),
    "cameraGridPoints": ("cameraGridPoints", "camera_grid_points"),
    "hiddenVolumePosition": ("hiddenVolumePosition", "volume_position"),
    "hiddenVolumeSize": ("hiddenVolumeSize", "volume_size"),
    "deltaT": ("deltaT", "deltat", "delta_t"),
    "c": ("c", "lightspeed"),
}


def _get(mat: dict, key: str, default=None):
    for alias in _KEY_ALIASES[key]:
        if alias in mat:
            return mat[alias]
    if default is not None:
        return default
    raise KeyError(f"none of {_KEY_ALIASES[key]} found in .mat file")


def load_zaragoza256_data(path: str) -> NLOSData:
    """Load a Zaragoza-style preprocessed confocal .mat file."""
    import scipy.io as sio

    mat = sio.loadmat(path)
    nlos_data = np.asarray(_get(mat, "data"), dtype=np.float32)
    camera_position = np.asarray(
        _get(mat, "cameraPosition", np.zeros(3)), dtype=np.float32
    ).reshape(-1)
    camera_grid_size = np.asarray(
        _get(mat, "cameraGridSize", np.ones(2)), dtype=np.float32
    ).reshape(-1)
    camera_grid_positions = np.asarray(
        _get(mat, "cameraGridPositions"), dtype=np.float32
    ).reshape(3, -1)
    camera_grid_points = np.asarray(
        _get(mat, "cameraGridPoints", np.array(nlos_data.shape[1:])),
        dtype=np.int32,
    ).reshape(-1)
    volume_position = np.asarray(
        _get(mat, "hiddenVolumePosition"), dtype=np.float32
    ).reshape(-1)
    volume_size = float(np.asarray(_get(mat, "hiddenVolumeSize")).reshape(-1)[0])
    delta_t = float(np.asarray(_get(mat, "deltaT")).reshape(-1)[0])
    c = float(np.asarray(_get(mat, "c", np.array(1.0))).reshape(-1)[0])
    return NLOSData(
        nlos_data=nlos_data,
        camera_position=camera_position,
        camera_grid_size=camera_grid_size,
        camera_grid_positions=camera_grid_positions,
        camera_grid_points=camera_grid_points,
        volume_position=volume_position,
        volume_size=volume_size,
        deltaT=delta_t,
        c=c,
    )


def save_zaragoza_mat(path: str, data: NLOSData) -> None:
    """Write an NLOSData to a Zaragoza-schema .mat (for tests / export)."""
    import scipy.io as sio

    sio.savemat(
        path,
        {
            "data": data.nlos_data,
            "cameraPosition": data.camera_position,
            "cameraGridSize": data.camera_grid_size,
            "cameraGridPositions": data.camera_grid_positions,
            "cameraGridPoints": data.camera_grid_points,
            "hiddenVolumePosition": data.volume_position,
            "hiddenVolumeSize": np.asarray(data.volume_size),
            "deltaT": np.asarray(data.deltaT),
            "c": np.asarray(data.c),
        },
    )
