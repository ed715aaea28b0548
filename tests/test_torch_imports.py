"""The PyTorch port never imports JAX or the JAX package.

A static check of every module's import statements: a runtime look at
`sys.modules` would be fooled by an interpreter that preloads jax."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "nlos_gaussian_renderer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "nlos_gaussian_renderer_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_the_mirrored_modules():
    for rel in ("configs/default.py", "models/scene.py", "models/densify.py", "ops/math.py",
                "ops/sampling.py", "ops/schedule.py", "ops/render.py",
                "ops/fused.py", "ops/fused_rsort.py", "ops/analytic.py",
                "ops/fused_analytic.py", "train.py", "data/synthetic.py",
                "data/zaragoza.py", "data/validate.py", "data/stanford.py",
                "utils/init.py", "utils/checkpoint.py", "utils/profiling.py",
                "utils/carving.py", "utils/export.py", "visualize.py", "cli.py",
                "tools/fitbench.py", "tools/microbench.py", "tools/cullbench.py",
                "tools/grad_parity.py", "tools/cli_speed_check.py", "ops/fused_dsort.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
                "parallel/launch.py", "parallel/dryrun.py", "tools/dsortbench.py",
                "tools/shardbench.py"):
        assert (PORT / rel).is_file(), rel
    kernels = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert kernels == {"cull_reduce.cu", "build_work_lists.cu", "rsort_fwd.cu",
                       "rsort_bwd.cu", "analytic_fwd.cu", "analytic_bwd.cu",
                       "field_fwd.cu", "field_bwd.cu", "worklist_add.cu"}


def test_ctypes_signatures_match_the_c_entry_points():
    """Each kernel's `extern "C"` entry takes what `cuda_build.SIGNATURES`
    passes it: a pointer (or the stream) where the C side has one, an int
    where it has an int, in order."""
    import re

    from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import _P, SIGNATURES

    seen = set()
    for path in sorted((PORT / "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', path.read_text(), re.S):
            args = [a.strip() for a in m.group(2).split(",")]
            is_ptr = ["*" in a or "cudaStream_t" in a for a in args]
            assert [t is _P for t in SIGNATURES[m.group(1)]] == is_ptr, m.group(1)
            seen.add(m.group(1))
    assert seen == set(SIGNATURES)
