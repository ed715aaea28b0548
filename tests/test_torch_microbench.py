"""PyTorch port vs the JAX package: the work-list microbenchmark kernel K9
(`tools/microbench.py`), through its plain version (CPU tensors), and the
port's microbenchmarks at tiny sizes.

The TPU kernel `_wl_kernel` adds into an output block it never
initialises, so its output is a function of its inputs only where every
item names the same block b: run in interpret mode with zeroed buffers, the
one output buffer then carries b's running sum from step to step. There the
port's plain version must equal it exactly (both add the same f32 values in
the same order). For lists that name several blocks the plain version is
held to numpy's `np.add.at` of 2x, exactly."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nlos_gaussian_renderer_tpu_torch.tools import cullbench, grad_parity
from nlos_gaussian_renderer_tpu_torch.tools import microbench as mb

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
KB, S, W = 8, 16, 20
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@functools.cache
def jax_wl_kernel():
    """`_wl_kernel` of tools/microbench.py, imported by path once. Executing the
    tool sets JAX's persistent compile cache; the previous settings are put
    back before anything compiles."""
    prev = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("_jax_microbench",
                                                  ROOT / "tools" / "microbench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
    return mod._wl_kernel


def jax_worklist(fb, cnt, x):
    """The pallas_call of tools/microbench.py:103-112, in interpret mode with
    zero-initialised buffers."""
    kb, s, _ = x.shape

    def g_map(i, fb_, cnt_):
        return (fb_[i], 0, 0)

    f = pl.pallas_call(
        jax_wl_kernel(),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(fb.shape[0],),
            in_specs=[pl.BlockSpec((1, s, 8), g_map)],
            out_specs=pl.BlockSpec((1, s, 8), g_map),
        ),
        out_shape=jax.ShapeDtypeStruct((kb, s, 8), jnp.float32),
        interpret=pltpu.InterpretParams(uninitialized_memory="zero"),
    )
    return np.asarray(f(jnp.asarray(fb), jnp.asarray(cnt), jnp.asarray(x)))


def plain(fb, cnt, x):
    return mb._worklist_add_plain(torch.as_tensor(fb), torch.as_tensor(cnt),
                                  torch.as_tensor(x)).numpy()


@pytest.mark.parametrize("cnt", [0, 1, W // 2, W])
def test_plain_equals_jax_kernel_where_it_is_defined(cnt):
    x = np.random.default_rng(0).standard_normal((KB, S, 8)).astype(np.float32)
    fb = np.full(W, 3, np.int32)
    c = np.array([cnt], np.int32)
    got = plain(fb, c, x)
    np.testing.assert_array_equal(got, jax_worklist(fb, c, x))
    assert (got[np.arange(KB) != 3] == 0).all()
    assert cnt == 0 or (got[3] != 0).any()


@pytest.mark.parametrize("seed,cnt", [(1, W), (2, 13), (3, 0)])
def test_plain_equals_numpy_on_unsorted_lists(seed, cnt):
    """Random lists name several blocks in no order. JAX cannot be the
    reference here: its kernel's output block starts from whatever the
    buffer held (another block's running sum), and interpret mode refuses a
    revisited block outright."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((KB, S, 8)).astype(np.float32)
    fb = rng.integers(0, KB, W).astype(np.int32)
    ref = np.zeros_like(x)
    np.add.at(ref, fb[:cnt], np.float32(2.0) * x[fb[:cnt]])
    np.testing.assert_array_equal(plain(fb, np.array([cnt], np.int32), x), ref)


FLT_MAX = float(np.finfo(np.float32).max)
COUNTED_CASES = ["cnt -1", "cnt 0", "cnt 23", "cnt w", "cnt w+5", "one block w times",
                 "negative zero", "subnormal", "overflow", "mixed"]


def _counted_case(case):
    """(fb, cnt, x) of one case: w = 40 items over kb = KB blocks of S rows."""
    rng = np.random.default_rng(COUNTED_CASES.index(case))
    w = 40
    x = rng.standard_normal((KB, S, 8)).astype(np.float32)
    fb = rng.integers(0, KB, w)
    cnt = w
    if case.startswith("cnt "):
        cnt = {"-1": -1, "0": 0, "23": 23, "w": w, "w+5": w + 5}[case[4:]]
    elif case == "one block w times":
        fb = np.full(w, 5)
    elif case == "negative zero":
        x[rng.random(x.shape) < 0.5] = -0.0
    elif case == "subnormal":
        x = (rng.standard_normal(x.shape) * 1e-40).astype(np.float32)
    elif case == "overflow":
        x = (np.sign(x) * rng.uniform(0.45, 0.5, x.shape) * FLT_MAX).astype(np.float32)
        fb = np.append(rng.integers(0, KB - 1, w - 1), KB - 1)  # block KB - 1 once
    elif case == "mixed":
        pick = rng.integers(0, 4, x.shape)
        x = np.where(pick == 0, -0.0, np.where(pick == 1, x * 1e-40,
                     np.where(pick == 2, x * 0.2 * FLT_MAX, x))).astype(np.float32)
        fb = rng.integers(0, 3, w)
    return (torch.as_tensor(fb.astype(np.int32)), torch.tensor([cnt], dtype=torch.int32),
            torch.as_tensor(x))


@pytest.mark.parametrize("case", COUNTED_CASES)
def test_counted_equals_plain_bit_for_bit(case):
    """The kernel's algorithm (count the ids, then add each block's 2x its
    count times from +0) against the in-order loop, compared as bits: any
    order of equal addends from +0 gives the same sums, -0 and subnormal
    values and overflow to inf included."""
    fb, cnt, x = _counted_case(case)
    got, ref = mb._worklist_add_counted(fb, cnt, x), mb._worklist_add_plain(fb, cnt, x)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    bits = ref.view(torch.int32)
    if case == "negative zero":  # 2 * -0 added from +0 gives +0
        assert (x.view(torch.int32) == -2**31).any() and not (bits == -2**31).any()
    elif case == "subnormal":
        assert ((ref != 0) & (ref.abs() < np.finfo(np.float32).tiny)).any()
    elif case == "overflow":
        assert torch.isinf(ref).any() and torch.isfinite(ref[ref != 0]).any()
    elif case in ("cnt -1", "cnt 0"):
        assert not bits.any()


def test_counted_skips_ids_outside_the_blocks_where_plain_raises():
    """Ids kb and -1 among the first cnt items: the counted form (the
    kernel's) skips them and equals the plain loop over the in-range ids;
    the plain loop raises."""
    fb, cnt, x = _counted_case("cnt w")
    fb[3], fb[17] = KB, -1
    with pytest.raises(ValueError, match="outside"):
        mb._worklist_add_plain(fb, cnt, x)
    keep = fb[(fb >= 0) & (fb < KB)]
    ref = mb._worklist_add_plain(keep, torch.tensor([keep.numel()], dtype=torch.int32), x)
    got = mb._worklist_add_counted(fb, cnt, x)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_wrapper_checks_its_arguments():
    x = torch.zeros((KB, S, 8))
    cnt = torch.tensor([4], dtype=torch.int32)
    # The plain version checks the ids of the items it runs, and only those.
    with pytest.raises(ValueError, match="outside"):
        mb.worklist_add(torch.tensor([0, KB, 1, 2], dtype=torch.int32), cnt, x)
    ok = mb.worklist_add(torch.tensor([0, 1, 2, 3, KB], dtype=torch.int32), cnt, x)
    assert ok.shape == x.shape
    # Off the CPU, the wrapper takes CUDA tensors of its shapes or raises.
    meta = torch.zeros((KB, S, 8), device="meta")
    fb = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mb.worklist_add(fb, cnt, meta)
    with pytest.raises(ValueError, match=r"\(kb, s, 8\)"):
        mb.worklist_add(fb, cnt, meta[..., :4])
    with pytest.raises(ValueError, match=r"\(w,\)"):
        mb.worklist_add(fb[None], cnt, meta)


def test_sort_key_wraps_as_int32():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 24, 1000).astype(np.int32)
    i = np.arange(1000, dtype=np.int32)
    want = ((k.astype(np.int64) * 1103515245 + i) & ((1 << 24) - 1)).astype(np.int32)
    got = mb.next_sort_key(torch.as_tensor(k), torch.as_tensor(i))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _finite(rows, keys):
    assert rows and all(np.isfinite(r[k]) and r[k] > 0 for r in rows for k in keys)


def test_bench_sort_and_scatter_add_on_cpu():
    _finite(mb.bench_sort((1000, 4000), device="cpu", iters=2), ["ms"])
    _finite(mb.bench_scatter_add(((2000, 1000),), device="cpu", iters=2), ["ms"])


def test_bench_worklist_kernel_on_cpu():
    rows = mb.bench_worklist_kernel(((16, 0, 32), (8, 0, 64)), kb=8, skewed=((8, 16),),
                                    device="cpu", iters=2)
    _finite(rows, ["ms", "us_per_item", "library_ms"])
    assert [(r["s"], r["w"], r["one_block"]) for r in rows] == [
        (16, 32, False), (8, 64, False), (8, 16, True)]
    assert all(r["graph_ms"] is None and r["library_graph_ms"] is None for r in rows)


def test_bench_rsort_step_components_on_cpu():
    rows = mb.bench_rsort_step_components(64, (4,), device="cpu", iters=1)
    _finite(rows, ["cull_ms", "cull_fwd_ms", "cull_fwd_bwd_ms"])
    assert rows[0]["n_items"] > 0 and not rows[0]["overflowed"]


def test_tools_raise_without_a_card():
    """Each tool runs on the card by default and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.bench_sort((100,))
    for run in (lambda: mb.main([]), lambda: cullbench.main([]),
                lambda: grad_parity.main(["--rows", "sigma3"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
