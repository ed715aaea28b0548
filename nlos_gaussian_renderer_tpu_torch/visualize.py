"""Transient-volume visualization (reference `visualize.py`).

A copy of `nlos_gaussian_renderer_tpu/visualize.py` on the port's
`NLOSData`. `cv2` and `matplotlib` are imported inside the functions that
use them, so the package imports without them.

Renders the (L, M, N) transient of a Zaragoza-style .mat (or an NLOSData) to
an .mp4 scrubbing through time bins, plus a histogram-comparison figure used
during training (reference `nlos_helpers.py:329-341`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData, load_zaragoza256_data


def visualize_transient_img(
    source,
    output_name: str = "transient.mp4",
    output_dir: str = "./output_videos",
    fps: float = 15.0,
) -> str:
    """Write the per-bin frames of a transient to an mp4.

    Args:
      source: path to a .mat file or an NLOSData.
    Returns:
      Path of the written video.
    """
    import cv2

    if isinstance(source, str):
        data = load_zaragoza256_data(source).nlos_data
    elif isinstance(source, NLOSData):
        data = source.nlos_data
    else:
        data = np.asarray(source)

    lo, hi = float(data.min()), float(data.max())
    norm = (data - lo) / max(hi - lo, 1e-12) * 127.0

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, output_name)
    h, w = data.shape[1], data.shape[2]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), isColor=False
    )
    try:
        for i in range(data.shape[0]):
            frame = np.clip(norm[i], 0, 255).astype(np.uint8)
            writer.write(frame)
    finally:
        writer.release()
    return path


def save_loss_compare(path, target_hist, pred_hist) -> None:
    """Write the measured/predicted histogram pair as a .mat
    (reference `nlos_helpers.py:343-344` wrote this unconditionally every
    iteration; here it is an explicit utility — call it from a training
    callback when needed)."""
    import scipy.io as sio

    sio.savemat(
        path,
        {
            "nlos": np.asarray(target_hist),
            "pred": np.asarray(pred_hist),
        },
    )


def save_histogram_figure(
    path: str,
    target_hist: np.ndarray,
    pred_hist: np.ndarray,
    camera_pos: Optional[np.ndarray] = None,
    equal_loss: Optional[float] = None,
) -> None:
    """Measured-vs-predicted histogram overlay (reference
    `nlos_helpers.py:329-341`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(np.asarray(target_hist), alpha=0.5, label="data")
    plt.plot(np.asarray(pred_hist), alpha=0.5, label="predicted")
    plt.legend(loc="upper right")
    title = ""
    if camera_pos is not None:
        title += f"grid position: {camera_pos[0]:.4f} {camera_pos[2]:.4f}"
    if equal_loss is not None:
        title += f"  equal loss: {equal_loss:.8f}"
    if title:
        plt.title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()
