"""The benchmark of the PyTorch and CUDA port (`nlos_gaussian_renderer_tpu_torch`):
its harness, its plain reference and its yardstick. `run.py` runs one cell;
`BENCHMARK.json`, at the root of the repository, names the cells and metrics."""
