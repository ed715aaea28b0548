"""PyTorch/CUDA port of the NLOS Gaussian transient renderer.

The JAX package `nlos_gaussian_renderer_tpu` beside this one is the reference:
every module here mirrors the module of the same name there and is held
against it by `tests/test_torch_*.py`. This package imports `torch` and never
`jax` (nor anything of the JAX package), so the numpy-only pieces it needs are
copied rather than imported.

Conventions:
  - `GaussianScene` is an `nn.Module`; everything else is plain functions on
    tensors, which follow their inputs' device. Functions that create tensors
    from host data take a `device`, by default the CUDA card (they raise
    without one; the CPU is used only when asked for, as the tests do).
  - Randomness comes from a caller's `torch.Generator` or from numpy, and
    in training from `ops/random.py`: counter-based draws keyed on
    `(seed, step)` with the step read on the device (the SGLD noise, the
    densify donors), so a replayed chunk draws what it drew before.
  - The eight Pallas kernels of the three kernel backends (`pallas`,
    `pallas_rsort`, `pallas_analytic`) are CUDA C++ kernels under `csrc/`,
    built on first use (`ops/cuda_build.py`), and so is the ninth, the
    work-list microbenchmark of `tools/microbench.py`. Each wrapper in
    `ops/fused.py`, `ops/fused_rsort.py`, `ops/fused_analytic.py` and
    `tools/microbench.py` launches its kernel for CUDA tensors and runs the
    plain PyTorch version beside it for CPU tensors.
  - `train.fit(cfg, optim, data, num_iters, ...)` is the training entry
    point (on the card by default, `device="cpu"` for the plain versions):
    `data` an `NLOSData` from `load_zaragoza256_data` or
    `data.synthetic.make_synthetic_dataset`. On the card its chunks of K
    steps replay a CUDA graph of one step, and a second graph of one MCMC
    densify step (`models/densify.py`) where an event falls.
  - `python -m nlos_gaussian_renderer_tpu_torch.cli` is the user's entry
    point, JAX's CLI with `--device` (default `cuda`): train (carved init, the
    vote on the device; checkpoints `step_{N}/state.npz`,
    `utils/checkpoint.py`), `--resume`, eval (density, normals, point
    cloud and mesh PLY, `utils/export.py`) and validate
    (`data/validate.py`).
  - `tools/` holds the measurement tools (microbench, cullbench,
    grad_parity, schedbench, fitbench, cli_speed_check): on the card by
    default, on the CPU when asked (schedbench, fitbench and
    cli_speed_check: the card only).
"""

__version__ = "0.1.0"

from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData, load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.densify import compute_relocation, densify_step
from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene, init_scene
from nlos_gaussian_renderer_tpu_torch.train import FitResult, fit, prepare_training

__all__ = [
    "Config",
    "OptimizationParams",
    "GaussianScene",
    "init_scene",
    "compute_relocation",
    "densify_step",
    "NLOSData",
    "load_zaragoza256_data",
    "FitResult",
    "fit",
    "prepare_training",
    "__version__",
]
