"""Microbenchmarks of the cull's and the kernels' design constants on the card.

Port of `tools/microbench.py`. Measures, on the device:
  1. `torch.sort` (one int32 key, stable, its int32 payload gathered) at
     several row counts: the cost model of the cull's sort.
  2. Row scatter-add (`index_add_` with duplicated sources) at several row
     counts: the backward combine of a duplicated layout.
  3. The work-list kernel K9 (`worklist_add`, `csrc/worklist_add.cu`: a
     count pass over the list, then one streaming pass that writes every
     block of o once) at several list lengths and at a list that names one
     block w times: the function's cost at the list's shapes, chained
     through CUDA events and replayed from a CUDA graph (the card's launch
     floor is `tools/schedbench.py`'s `launch_floor_ms`). Beside it, the one
     `index_add_` call that computes the same function (a yardstick only).
  4. `--rsort`: the `pallas_rsort` step of the 100k bench scene taken apart
     into cull, cull + forward and cull + forward + backward.

Every function takes `device` ("cuda" by default, which raises without a
card; "cpu" runs the kernels' plain versions) and returns its rows as well
as printing them. Each timed call consumes the last one's result (chained),
but for K9's graph replay.

    python -m nlos_gaussian_renderer_tpu_torch.tools.microbench [--rsort] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import (
    KERNELS,
    check_tensor,
    on_cpu,
    ptr,
)
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    PROBE_CAMS,
    START,
    bench_scene,
    device_name,
    elapsed_ms,
    resolve_device,
)

SORT_SIZES = (100_000, 200_000, 400_000, 800_000)
SCATTER_SHAPES = ((200_000, 100_000), (400_000, 100_000), (800_000, 100_000))
# (s, k, w) of the JAX tool: block rows s, an unused k, list length w.
WORKLIST_SHAPES = (
    (1024, 256, 512), (1024, 256, 1024), (1024, 256, 2048),
    (4096, 256, 512), (4096, 256, 1024),
    (256, 256, 2048), (256, 256, 4096),
)
WORKLIST_KB = 512
# (s, w) of the skewed list: block kb // 3 named by all w items.
WORKLIST_SKEWED = ((4096, 1024),)


def timeit_chained(fn, state, iters=20):
    """fn: state -> state (a tensor or a tuple of tensors). One warm-up
    call, then `iters` chained calls timed together (CUDA events and one
    synchronize on the card, the host clock on the CPU): ms per iteration."""
    state = fn(state)
    first = state if isinstance(state, torch.Tensor) else state[0]

    def run():
        nonlocal state
        for _ in range(iters):
            state = fn(state)

    return elapsed_ms(first.device, run) / iters


# --- 1, 2: sort and scatter-add ------------------------------------------------


def next_sort_key(k, i):
    """(k * 1103515245 + i) & (2^24 - 1) in int32 arithmetic, which wraps
    around as in JAX: a cheap re-randomisation of the sort's key."""
    return (k * 1103515245 + i) & ((1 << 24) - 1)


def bench_sort(sizes=SORT_SIZES, device="cuda", iters=20):
    """Stable sort of an int32 key with its int32 payload gathered, the key
    re-randomised each call (`next_sort_key`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        keys = torch.as_tensor(rng.integers(0, 1 << 24, n).astype(np.int32), device=dev)
        idx = torch.arange(n, dtype=torch.int32, device=dev)

        def f(st):
            k, i = st
            vals, order = torch.sort(next_sort_key(k, i), stable=True)
            return vals, i[order]

        ms = timeit_chained(f, (keys, idx), iters)
        print(f"sort   n={n:>7}: {ms:7.3f} ms")
        rows.append({"n": n, "ms": ms})
    return rows


def bench_scatter_add(shapes=SCATTER_SHAPES, device="cuda", iters=20):
    """`index_add_` of n rows of 12 floats into g rows (duplicated targets),
    chained as r + out[s % g] * 1e-9."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for n, g in shapes:
        src = torch.as_tensor(rng.integers(0, g, n).astype(np.int32), device=dev)
        vals = torch.as_tensor(rng.standard_normal((n, 12)).astype(np.float32), device=dev)

        def f(st, g=g):
            s_, r = st
            out = torch.zeros((g, 12), dtype=torch.float32, device=dev).index_add_(0, s_, r)
            return s_, r + out[s_ % g] * 1e-9

        ms = timeit_chained(f, (src, vals), iters)
        print(f"scatt  n={n:>7}: {ms:7.3f} ms")
        rows.append({"n": n, "g": g, "ms": ms})
    return rows


# --- 3: K9, the work-list kernel -----------------------------------------------


def worklist_add(fb, cnt, x):
    """K9: (kb, s, 8) f32 `o`, zero, then o[fb[i]] += 2 * x[fb[i]] for every
    i < cnt[0] (and i < w), in list order.

    fb (w,) int32 block ids; cnt (1,) int32 stays on the device (no host
    sync); x (kb, s, 8) f32, 16-byte aligned. Repeated ids accumulate;
    blocks no item names are 0. CUDA tensors launch the kernel: a count pass
    over the list, then one streaming pass that writes every block of `o`
    once (no fill, no float atomics). It skips ids outside [0, kb) and
    equals the plain version over the in-range ids bit for bit (every
    addend of an element is the same value, added from +0). CPU tensors run
    the plain version, which raises on such ids."""
    if on_cpu(fb, cnt, x):
        return _worklist_add_plain(fb, cnt, x)
    if x.dim() != 3 or x.shape[2] != 8:
        raise ValueError(f"x must be (kb, s, 8), got {tuple(x.shape)}")
    if fb.dim() != 1:
        raise ValueError(f"fb must be (w,), got {tuple(fb.shape)}")
    check_tensor(fb, "fb", torch.int32)
    check_tensor(cnt, "cnt", torch.int32, (1,))
    check_tensor(x, "x", torch.float32)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    o = torch.empty_like(x)
    counts = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    KERNELS["worklist_add"].launch(ptr(fb), ptr(cnt), ptr(x), ptr(o), ptr(counts),
                                   fb.shape[0], x.shape[0], x.shape[1] * x.shape[2])
    return o


def _worklist_add_plain(fb, cnt, x):
    """The items in list order, as the TPU's grid runs them. Raises on an id
    of the first min(cnt, w) items outside [0, kb).

    This is the function the TPU kernel was meant to have. Where every item
    names one block b, the TPU kernel computes it too (in interpret mode
    with zeroed buffers): its single output buffer then carries b's running
    sum from step to step. For a list that names several blocks it is no
    reference: a block's output starts from whatever the buffer held (an
    earlier block's sum), and interpret mode refuses an unsorted list
    outright."""
    n = max(min(int(cnt.reshape(-1)[0]), fb.shape[0]), 0)
    ids = fb[:n].tolist()
    kb = x.shape[0]
    bad = [b for b in ids if not 0 <= b < kb]
    if bad:
        raise ValueError(f"block ids {bad[:4]} outside [0, {kb})")
    o = torch.zeros_like(x)
    for b in ids:
        o[b] += 2.0 * x[b]
    return o


def _worklist_add_counted(fb, cnt, x):
    """The kernel's algorithm in torch: count each in-range id of the first
    min(max(cnt, 0), w) items (ids outside [0, kb) are skipped), then give
    each block its 2 * x added count times from +0. Equal to
    `_worklist_add_plain` bit for bit over the in-range ids."""
    n = max(min(int(cnt.reshape(-1)[0]), fb.shape[0]), 0)
    kb = x.shape[0]
    ids = fb[:n].long()
    counts = torch.bincount(ids[(ids >= 0) & (ids < kb)], minlength=kb)
    o = torch.zeros_like(x)
    for b in torch.nonzero(counts).flatten().tolist():
        v = 2.0 * x[b]
        acc = torch.zeros_like(v)
        for _ in range(int(counts[b])):
            acc += v
        o[b] = acc
    return o


def _index_add_worklist(fb, x):
    """K9's function in one PyTorch call at cnt = w: the yardstick the
    tools time beside the kernel (no computation of the port uses it)."""
    return torch.zeros_like(x).index_add_(0, fb, x.index_select(0, fb), alpha=2.0)


def bench_worklist_kernel(shapes=WORKLIST_SHAPES, kb=WORKLIST_KB, skewed=WORKLIST_SKEWED,
                          device="cuda", iters=20):
    """K9 over x (kb, s, 8) f32 at cnt = w: a random list of w block ids at
    each of `shapes` ((s, k, w), k unused as in JAX's tool), then a list
    that names one block w times at each of `skewed` ((s, w)).

    What is timed is the function's cost at the list's shapes, both launches
    in: `iters` calls chained as JAX chains them (the output becomes the
    next call's x) between CUDA events, and on the card also 50 calls of
    the same inputs replayed from one CUDA graph (`schedbench.graph_ms`:
    without the host's launch latency; the card's floor for one launch is
    `schedbench.launch_floor_ms`). Beside them the `index_add_` yardstick,
    timed both ways. Returns ms and us per item of each (`graph_ms` and
    `library_graph_ms` None on the CPU)."""
    from nlos_gaussian_renderer_tpu_torch.tools.schedbench import graph_ms

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    lists = [(s, w, False) for s, _, w in shapes] + [(s, w, True) for s, w in skewed]
    for s, w, one_block in lists:
        x = torch.as_tensor(rng.standard_normal((kb, s, 8)).astype(np.float32), device=dev)
        ids = np.full(w, kb // 3) if one_block else rng.integers(0, kb, w)
        fb = torch.as_tensor(ids.astype(np.int32), device=dev)
        cnt = torch.tensor([w], dtype=torch.int32, device=dev)
        ms = timeit_chained(lambda st: (st[0], st[1], worklist_add(*st)), (fb, cnt, x), iters)
        lib = timeit_chained(lambda st: (st[0], st[1], _index_add_worklist(st[0], st[2])),
                             (fb, cnt, x), iters)
        graph = lib_graph = None
        if dev.type == "cuda":
            graph = graph_ms(lambda: worklist_add(fb, cnt, x))
            lib_graph = graph_ms(lambda: _index_add_worklist(fb, x))
        print(f"wlkern s={s:>5} w={w:>5}: {ms:7.3f} ms ({ms * 1000 / w:6.2f} us/item); "
              f"index_add_ {lib:7.3f} ms ({lib * 1000 / w:6.2f} us/item)"
              + (f"; graph {graph:7.4f} ms, index_add_ {lib_graph:7.4f} ms"
                 if graph is not None else "")
              + ("  [one block]" if one_block else ""))
        rows.append({"s": s, "w": w, "one_block": one_block, "ms": ms,
                     "us_per_item": ms * 1000 / w, "graph_ms": graph, "library_ms": lib,
                     "library_us_per_item": lib * 1000 / w, "library_graph_ms": lib_graph})
    return rows


# --- 4: the rsort step taken apart ----------------------------------------------


def bench_rsort_step_components(gaussians=100_000, gate_bins_list=(4, 32),
                                device="cuda", iters=20):
    """The `pallas_rsort` step's pieces at the bench scene, each timed alone:
    the cull, cull + forward field, cull + forward + backward (t_chunk 32,
    caps tuned on the three probe cameras). The port computes in f32, so
    JAX's inner bf16-backward loop has no counterpart: one row per gate."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import (
        RSortSpec,
        rsort_cull,
        rsort_gaussian_field,
        tune_rsort_spec,
    )
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    dev = resolve_device(device)
    scene, box, _ = bench_scene(gaussians, device=dev)
    cam = torch.zeros(3, device=dev)
    grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
    with torch.no_grad():
        gfeat = scene.quadratic_form(1.0)
        op = scene.opacities[:, 0]
        w2 = torch.stack([op, op * 0.5], dim=1)
        scales = scene.scales
    means = scene.means.detach()

    rows = []
    for gb in gate_bins_list:
        spec = tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                               base=RSortSpec(t_chunk=32, gate_bins=gb))

        def cull(mu, gw=None, spec=spec):
            return rsort_cull(mu, scales, scene.alive, cam, grid.theta, grid.phi,
                              grid.r, spec, gw=gw)

        @torch.no_grad()
        def cull_chain(mu):
            t = cull(mu)
            return mu + t.n_items[0].to(torch.float32) * 1e-12

        @torch.no_grad()
        def fwd_fn(gf, spec=spec, cull=cull):
            tiles = cull(means, torch.cat([gf, w2], 1))
            f, _ = rsort_gaussian_field(gf, w2, tiles, spec, grid, cam)
            return gf + torch.sum(f) * 1e-12

        def fwdbwd_fn(gf, spec=spec, cull=cull):
            g_ = gf.detach().requires_grad_(True)
            tiles = cull(means, torch.cat([g_, w2], 1))
            f, _ = rsort_gaussian_field(g_, w2, tiles, spec, grid, cam)
            (g,) = torch.autograd.grad(torch.sum(f), g_)
            return g_.detach() + g * 1e-12

        with torch.no_grad():
            t = cull(means)
        ms_c = timeit_chained(cull_chain, means, iters)
        ms_f = timeit_chained(fwd_fn, gfeat, iters)
        ms_fb = timeit_chained(fwdbwd_fn, gfeat, iters)
        print(f"rsort gate={gb:>2} (f32): cull {ms_c:6.3f}  cull+fwd {ms_f:6.3f}  "
              f"cull+fwd+bwd {ms_fb:6.3f} ms  (w_max {spec.w_max}, n_items "
              f"{int(t.n_items[0])}, overflow {bool(t.overflowed)})")
        rows.append({"gate_bins": gb, "w_max": spec.w_max, "max_groups": spec.max_groups,
                     "n_items": int(t.n_items[0]), "overflowed": bool(t.overflowed),
                     "cull_ms": ms_c, "cull_fwd_ms": ms_f, "cull_fwd_bwd_ms": ms_fb})
    print("(JAX's bf16-backward rows have no counterpart: the port computes in f32)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rsort", action="store_true",
                    help="time the rsort step's components at the 100k bench scene")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device_name(dev)}", file=sys.stderr)
    if args.rsort:
        bench_rsort_step_components(device=dev)
    else:
        bench_sort(device=dev)
        bench_scatter_add(device=dev)
        bench_worklist_kernel(device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
