"""The port's multi-device step (`parallel/`) on gloo worlds of CPU
processes, against JAX's single-device step and the port's own.

Counterparts of tests/test_sharding.py (its setup: synthetic set seed 1, 4x4
scan, 64 bins, 32 Gaussians, SH degree 1, B 4) on meshes (2, 2) and (1, 4).
Each world is one `parallel.dryrun.run_cases` spawn of 4 processes in a
module-scoped fixture (a 120 s limit each); the children import only the
port, and JAX runs here, on its virtual devices. Tolerances: JAX's (loss
rtol 1e-4; means and logit opacities rtol 1e-3 / atol 1e-6; the sharded
render rtol 2e-3 / atol 1e-5 against the unsharded one and against JAX's
render on the same shards, 3e-3 of the peak for the work-list backends,
`CULL_BACKENDS`, whose tails depend on the blocks; the K-step chunk against K
sharded steps rtol 1e-5); the sharded render against the sum of the
shards' own renders rtol 1e-5; the sharded densify step against the
single-device one bit for bit; the sharded gradient against the port's
single-device gradient 1e-5 and JAX's `jax.grad` 1e-4 of each group's
largest entry (measured 2.0e-6 and 1.9e-5).

Two pins of JAX's sharded step, reference caveats (the JAX package stays
as it is): its gradient is n_gauss times JAX's single-device `jax.grad`
(the transpose of `psum` under `check_vma=False`), and an overflow raised
only on a Gaussian shard past the first comes out False. The port's
gradient is the single-device one and its flag is raised."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nlos_gaussian_renderer_tpu import train as jtrain
from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu.ops.fused_rsort import RSortSpec as JRSortSpec
from nlos_gaussian_renderer_tpu.parallel.mesh import make_mesh as j_make_mesh
from nlos_gaussian_renderer_tpu.parallel.sharding import make_sharded_train_step as j_sharded
from nlos_gaussian_renderer_tpu.parallel.sharding import shard_scene as j_shard_scene
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops.fused import TileSpec
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    render_histogram_batch,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.parallel import dryrun, launch, mesh, sharding
from test_torch_fit import generic_pose

torch.set_num_threads(1)
NB = 64
RSPEC = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=128, max_groups=16)
DSPEC = dict(t_theta=2, t_phi=2, t_chunk=8, g_tile=32, w_max=1024, d_max=16)
TSPEC = TileSpec(t_theta=4, t_phi=8, t_r=16, k_max=64)
# The work-list backends cull by block, and their kernels cover each
# (tile, chunk, block) item's bins [bl, bh] only: the sub-cutoff tails
# (below exp(-(3 * 1.1)^2 / 2) of a Gaussian's peak) a render keeps depend
# on which Gaussians share a block, so one shard's rows keep other tails
# than all rows in the first bins (this scene's sigmas reach 29 cm). JAX's
# kernels do the same over their gate ladder's wider bin ranges: at 4
# shards JAX's own sharded render is 4.5e-4 of the peak from its unsharded
# one, the port's 2.3e-3 from its own and 2.2e-3 from JAX's sharded one
# (the first two bins). So atol 3e-3 of the peak for `CULL_BACKENDS`,
# as tests/test_dsort.py:178-183 holds dsort to rsort at 1e-3; JAX's atol
# 1e-5 for the others.
CULL_BACKENDS = ("pallas_rsort", "pallas_analytic", "pallas_dsort")
RENDER_CASES = [("analytic", False), ("analytic", True), ("pallas", True),
                ("pallas_rsort", False), ("pallas_rsort", True),
                ("pallas_analytic", False), ("pallas_analytic", True),
                ("pallas_dsort", False), ("pallas_dsort", True)]


@pytest.fixture(scope="module")
def setup():
    """JAX's tests/test_sharding.py setup, and the port's settings for it."""
    data = make_synthetic_dataset(seed=1, scan_m=4, scan_n=4, num_bins=NB,
                                  num_gt_gaussians=8, num_sampling_points=8)
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    cfg = JConfig(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8,
                  sh_degree=1, init_gaussian_num=32, space_carving_init=False,
                  batch_size=4)
    optim = JOptim()
    scene, tx, settings, box = jtrain.prepare_training(cfg, optim, data)
    tset = RenderSettings(num_sampling_points=8, start=cfg.start, end=cfg.end)
    return dict(data=data, cfg=cfg, optim=optim, scene=scene, tx=tx, settings=settings,
                box=box, tset=tset)


def scene_arrays(jscene) -> dict:
    return {n: np.array(getattr(jscene, n), np.float32) for n in FIELD_NAMES}


def port_state(scene: dict) -> dict:
    """The fresh port state of a scene, as host arrays."""
    st = ttrain.create_train_state(scene_from_numpy(scene, "cpu"), OptimizationParams())
    return ttrain.train_state_to_numpy(st)


def batch(s, idx):
    d, cfg = s["data"], s["cfg"]
    tgt = d.nlos_data.reshape(NB, -1)[cfg.start:cfg.end] * cfg.gt_times
    return (np.asarray(d.camera_grid_positions.T[idx], np.float32),
            np.asarray(tgt.T[idx], np.float32))


def batches(s, rng, k):
    cams, tgts = zip(*(batch(s, rng.integers(0, 16, size=4)) for _ in range(k)))
    return np.stack(cams), np.stack(tgts)


def consts(s):
    d = s["data"]
    return (np.asarray(s["box"]), d.c, d.deltaT, np.asarray(d.volume_position, np.float32))


def steps_case(s, settings, state, cams, tgts, **kw):
    return dict(kind="steps", settings=settings, optim=OptimizationParams(),
                sh_degree=s["cfg"].sh_degree, state=state, cams=cams, targets=tgts,
                consts=consts(s), **kw)


def port_settings(s, backend, occ=False):
    return s["tset"]._replace(backend=backend, occlusion=occ, tile_spec=TSPEC,
                              rsort_spec=RSortSpec(**(DSPEC if backend == "pallas_dsort"
                                                      else RSPEC)))


def posed(s):
    """JAX's scene in a generic pose (random rotations, anisotropic
    scales): every group carries a gradient above rounding noise."""
    return generic_pose(s["scene"], np.random.default_rng(6))


def densify_scene(s) -> dict:
    """JAX's densify test scene: a third nearly dead, the last 8 slots free."""
    d = scene_arrays(s["scene"])
    d["logit_opacities"][::3] = -12.0
    d["alive"][24:] = 0.0
    return d


@pytest.fixture(scope="module")
def world22(setup):
    """One (2, 2) world: the step, stability, backends, chunk, densify and
    convergence cases."""
    s = setup
    start = port_state(scene_arrays(s["scene"]))
    cams0, tgts0 = batch(s, np.random.default_rng(0).integers(0, 16, size=4))
    cams4, tgts4 = batch(s, np.arange(4))
    cams_k, tgts_k = batches(s, np.random.default_rng(5), 3)
    dense, rsort = port_settings(s, "dense"), port_settings(s, "pallas_rsort")
    cases = {
        "dense_1": steps_case(s, dense, start, cams0[None], tgts0[None]),
        "stability": steps_case(s, dense, start, *batches(s, np.random.default_rng(1), 3)),
        "pallas_1": steps_case(s, port_settings(s, "pallas"), start, cams4[None],
                               tgts4[None]),
        "rsort_1": steps_case(s, rsort, start, cams4[None], tgts4[None]),
        "converge": steps_case(s, dense, start, *batches(s, np.random.default_rng(7), 40)),
        "densify": steps_case(s, dense, port_state(densify_scene(s)), cams_k[:0],
                              tgts_k[:0], densify=(32, 11)),
    }
    for name, st in (("dense", dense), ("rsort", rsort)):
        cases[f"seq_{name}"] = steps_case(s, st, start, cams_k, tgts_k)
        cases[f"chunk_{name}"] = steps_case(s, st, start, cams_k, tgts_k, chunk=True)
    return dryrun.run_cases(4, "gloo", (2, 2), cases, device="cpu")


@pytest.fixture(scope="module")
def world14(setup):
    """One (1, 4) world: the step, the sharded renders, the gradient and
    the overflow pins."""
    s = setup
    scene = scene_arrays(s["scene"])
    start = port_state(scene)
    cams0, tgts0 = batch(s, np.random.default_rng(0).integers(0, 16, size=4))
    cam3 = np.asarray(s["data"].camera_grid_positions[:, 3], np.float32)
    cases = {"dense_1": steps_case(s, port_settings(s, "dense"), start, cams0[None],
                                   tgts0[None]),
             "grad": dict(steps_case(s, port_settings(s, "dense"),
                                     port_state(scene_arrays(posed(s))), cams0, tgts0),
                          kind="grad")}
    cases["grad_reg"] = dict(cases["grad"], optim=OptimizationParams(regularization=True))
    for backend, occ in RENDER_CASES:
        cases[f"render_{backend}_{occ}"] = dict(
            steps_case(s, port_settings(s, backend, occ), start, cam3, tgts0), kind="render",
            sh_degree=1)
    starved = dict(scene, alive=np.where(np.arange(32) < 8, 0.0, 1.0).astype(np.float32))
    rs = port_settings(s, "pallas_rsort")
    cases["overflow"] = steps_case(s, rs._replace(rsort_spec=rs.rsort_spec._replace(w_max=1)),
                                   port_state(starved), cams0[None], tgts0[None])
    return dryrun.run_cases(4, "gloo", (1, 4), cases, device="cpu")


def sharded_state(world, name, scan_idx=0, n_gauss=2):
    ranks = world[scan_idx * n_gauss:(scan_idx + 1) * n_gauss]
    return dryrun.full_state([r[name]["state"] for r in ranks])


def test_mesh_coords_and_state_specs(setup, world22):
    """Rank r sits at divmod(r, n_gauss) (JAX's reshape order); the specs
    shard every row tensor over `gauss` (tests/test_sharding.py:111)."""
    assert [tuple(r["coords"]) for r in world22] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    st = ttrain.create_train_state(scene_from_numpy(scene_arrays(setup["scene"]), "cpu"),
                                   OptimizationParams())
    specs = sharding.state_specs(st)
    assert specs["scene.means"] == ("gauss", None)
    assert specs["scene.alive"] == ("gauss",)
    assert specs["mu.rotation"] == ("gauss", None)
    assert specs["step"] == () and specs["count"] == ()


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_matches_single_device(setup, world22, world14, sizes):
    """tests/test_sharding.py:52: one sharded step against JAX's
    single-device step from the same state and batch."""
    s = setup
    world = world22 if sizes == (2, 2) else world14
    cams, tgts = batch(s, np.random.default_rng(0).integers(0, 16, size=4))
    single = jtrain.make_train_step(s["settings"], s["optim"], s["tx"], s["cfg"].sh_degree,
                                    donate=False)
    s1, a1 = single(jtrain.create_train_state(s["scene"], s["tx"]), jnp.asarray(cams),
                    jnp.asarray(tgts), s["box"], s["data"].c, s["data"].deltaT,
                    jnp.asarray(s["data"].volume_position))
    got = sharded_state(world, "dense_1", n_gauss=sizes[1])
    np.testing.assert_allclose(world[0]["dense_1"]["losses"][0], float(a1.loss), rtol=1e-4)
    for name in ("means", "logit_opacities"):
        np.testing.assert_allclose(got["scene"][name], np.asarray(getattr(s1.scene, name)),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    if sizes == (2, 2):  # the two scan replicas hold the same rows
        other = sharded_state(world, "dense_1", scan_idx=1)
        for name in FIELD_NAMES:
            np.testing.assert_array_equal(other["scene"][name], got["scene"][name])


def test_multi_step_stability(world22):
    """tests/test_sharding.py:90: three sharded steps, finite, step 4."""
    r = world22[0]["stability"]
    assert np.all(np.isfinite(r["losses"])) and r["state"]["step"] == 4


def jax_sharded_render(s, backend, occ):
    """JAX's render of the scene split over 4 Gaussian shards (mesh (1, 4)
    of its virtual devices), the fields psum-ed over `gauss` as in
    tests/test_sharding.py:126."""
    from nlos_gaussian_renderer_tpu.ops.fused import TileSpec as JTileSpec
    from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render

    d = s["data"]
    spec = JTileSpec(t_theta=4, t_phi=8, t_r=16, k_max=64, a_sub=256, g_tile=32)
    rspec = JRSortSpec(**(DSPEC if backend == "pallas_dsort" else RSPEC))
    js = s["settings"]._replace(backend=backend, occlusion=occ, tile_spec=spec,
                                rsort_spec=rspec)
    cam = jnp.asarray(d.camera_grid_positions[:, 3])
    vol = jnp.asarray(d.volume_position)
    jmesh = j_make_mesh([1, 4], ("scan", "gauss"), devices=jax.devices()[:4])
    specs = jax.tree.map(lambda l: P("gauss", *([None] * (l.ndim - 1))), s["scene"])

    def fn(sc):
        return j_render(sc, cam, s["box"], d.c, d.deltaT, vol, 1, js, gauss_axis="gauss")[1]

    return np.asarray(jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(specs,), out_specs=P(),
                                            check_vma=False))(s["scene"]))


@pytest.mark.parametrize("backend,occ", RENDER_CASES)
def test_gauss_sharded_matches_unsharded(setup, world14, backend, occ):
    """tests/test_sharding.py:126 (and `pallas_dsort`): each of 4 Gaussian
    shards renders its rows, the fields summed over `gauss` before
    compositing, against the unsharded render and against JAX's render on
    the same 4 shards (`CULL_BACKENDS`' atol, rtol 2e-3); without occlusion
    (a histogram linear in the population) also against the sum of the four
    shards' own renders, rtol 1e-5."""
    s = setup
    cam = torch.as_tensor(np.asarray(s["data"].camera_grid_positions[:, 3], np.float32))
    box, c, dt, vol = consts(s)

    def hist(scene):
        return render_transient(scene_from_numpy(scene, "cpu"), cam, torch.as_tensor(box), c,
                                dt, torch.as_tensor(vol), 1, port_settings(s, backend, occ))[1]

    scene = scene_arrays(s["scene"])
    ref = hist(scene).detach().numpy()
    jax_sharded = jax_sharded_render(s, backend, occ)
    if not occ:
        parts = sum(hist({n: v[8 * i:8 * (i + 1)] for n, v in scene.items()})
                    for i in range(4)).detach().numpy()
        for r in world14:
            np.testing.assert_allclose(r[f"render_{backend}_{occ}"]["hist"], parts, rtol=1e-5,
                                       atol=1e-9)
    atol = 3e-3 * np.abs(ref).max() if backend in CULL_BACKENDS else 1e-5
    for r in world14:
        got = r[f"render_{backend}_{occ}"]
        assert not got["overflow"]
        np.testing.assert_allclose(got["hist"], ref, rtol=2e-3, atol=atol)
        np.testing.assert_allclose(got["hist"], jax_sharded, rtol=2e-3, atol=atol)


@pytest.mark.parametrize("backend", CULL_BACKENDS)
def test_gauss_sharded_render_is_within_the_tail_bound(setup, world14, backend):
    """The gloo world's sharded histograms (4 Gaussian shards) against the
    uncut float64 render: within tests/test_torch_shard_tails.py's bound
    (sub-cutoff tails, the backend's own f32 floor and summation order)
    summed over each bin's rays, a positive map, plus 1e-6 of the peak
    for the histogram's f32 sums. So the gap that
    `test_gauss_sharded_matches_unsharded` holds at 3e-3 of the peak is
    tails that the shards' blocks keep, not a fault."""
    from test_torch_shard_tails import jax_scene_case, tail_bound

    arrays, cam, box, c, dt, vol, settings, sh_degree = jax_scene_case(setup, backend)
    exact, _, bound, _ = tail_bound(arrays, cam, box, c, dt, vol, settings, sh_degree)
    grid = shell_grid(cam, box, settings.num_sampling_points, settings.start, settings.end,
                      c, dt)

    def per_bin(x):
        return x.reshape(settings.num_bins, -1).sum(1).numpy() * float(grid.dtheta * grid.dphi)

    want, limit = per_bin(exact), per_bin(bound) + 1e-6 * np.abs(per_bin(exact)).max()
    for r in world14:
        got = r[f"render_{backend}_False"]["hist"]
        assert np.all(np.abs(got - want) <= limit), np.max(np.abs(got - want) / limit)


def test_full_sharded_step_with_pallas_backend(world22):
    """tests/test_sharding.py:170: a finite sharded step on `pallas`."""
    r = world22[0]["pallas_1"]
    assert np.all(np.isfinite(r["losses"]))
    for name, v in sharded_state(world22, "pallas_1")["scene"].items():
        assert np.all(np.isfinite(v)), name


def test_full_sharded_step_with_rsort_backend(setup, world22):
    """tests/test_sharding.py:194: the sharded `pallas_rsort` step against
    JAX's single-device step."""
    s = setup
    cams, tgts = batch(s, np.arange(4))
    js = s["settings"]._replace(backend="pallas_rsort", rsort_spec=JRSortSpec(**RSPEC))
    single = jtrain.make_train_step(js, s["optim"], s["tx"], s["cfg"].sh_degree,
                                    donate=False)
    s1, a1 = single(jtrain.create_train_state(s["scene"], s["tx"]), jnp.asarray(cams),
                    jnp.asarray(tgts), s["box"], s["data"].c, s["data"].deltaT,
                    jnp.asarray(s["data"].volume_position))
    r = world22[0]["rsort_1"]
    assert np.isfinite(r["losses"][0]) and not any(r["overflow"])
    np.testing.assert_allclose(r["losses"][0], float(a1.loss), rtol=1e-4)
    np.testing.assert_allclose(sharded_state(world22, "rsort_1")["scene"]["means"],
                               np.asarray(s1.scene.means), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "rsort"])
def test_matches_sequential_sharded(world22, backend):
    """tests/test_sharding.py:250: the sharded K-step chunk (eager on gloo)
    against K sharded steps."""
    seq, chunk = world22[0][f"seq_{backend}"], world22[0][f"chunk_{backend}"]
    np.testing.assert_allclose(chunk["losses"], seq["losses"], rtol=1e-5)
    assert not any(chunk["overflow"]) and chunk["chunk_stats"]["graphs"] is False
    a, b = sharded_state(world22, f"chunk_{backend}"), sharded_state(world22, f"seq_{backend}")
    assert a["step"] == b["step"] == 4
    np.testing.assert_allclose(a["scene"]["means"], b["scene"]["means"], rtol=1e-5,
                               atol=1e-7)


def test_sharded_densify_matches_single_device(setup, world22):
    """tests/test_sharding.py:305: the sharded densify step (rows gathered,
    `densify_step` whole on every rank, own rows kept) equals the port's
    single-device densify step bit for bit."""
    d = densify_scene(setup)
    st = ttrain.create_train_state(scene_from_numpy(d, "cpu"), OptimizationParams())
    densify_step(st.scene, st.opt_state, 11, st.step, 32)
    want = ttrain.train_state_to_numpy(st)
    got = sharded_state(world22, "densify")
    for name in FIELD_NAMES:
        np.testing.assert_array_equal(got["scene"][name], want["scene"][name], err_msg=name)
    for g in ttrain.GROUPS:
        np.testing.assert_array_equal(got["mu"][g], want["mu"][g], err_msg=g)
        np.testing.assert_array_equal(got["nu"][g], want["nu"][g], err_msg=g)
    assert got["scene"]["alive"].sum() > d["alive"].sum()


def test_loss_decreases_on_mesh(setup, world22):
    """tests/test_sharding.py:354: 40 sharded steps on the (2, 2) mesh; the
    loss on 8 scan points falls below 0.9 of its start."""
    s = setup
    cams, tgts = batch(s, np.arange(8))
    box, c, dt, vol = consts(s)

    def val_loss(scene, deg):
        pred = render_histogram_batch(scene, torch.as_tensor(cams), torch.as_tensor(box), c,
                                      dt, torch.as_tensor(vol), deg, s["tset"])
        return float(torch.mean((pred - torch.as_tensor(tgts)) ** 2))

    with torch.no_grad():
        before = val_loss(scene_from_numpy(scene_arrays(s["scene"]), "cpu"), 0)
        got = sharded_state(world22, "converge")
        after = val_loss(scene_from_numpy(got["scene"], "cpu"), got["active_sh_degree"])
    assert np.all(np.isfinite(world22[0]["converge"]["losses"]))
    assert after < before * 0.9, (before, after)


@pytest.mark.parametrize("reg", [False, True], ids=["mse", "regularized"])
def test_sharded_gradient_is_the_true_gradient(setup, world14, reg):
    """The port's gradient on 4 Gaussian shards equals its single-device
    gradient and JAX's `jax.grad`; JAX's own sharded gradient
    (`shard_map(..., check_vma=False)`, as its sharded step takes it) is 4
    times `jax.grad` (a reference caveat). With the regularizers, whose
    sums run over the shards too (JAX's `train.py:138-140`)."""
    s = setup
    cams, tgts = batch(s, np.random.default_rng(0).integers(0, 16, size=4))
    args = (jnp.asarray(cams), jnp.asarray(tgts), s["box"], s["data"].c, s["data"].deltaT,
            jnp.asarray(s["data"].volume_position), jnp.int32(0), s["settings"],
            s["optim"].replace(regularization=reg))
    case = "grad_reg" if reg else "grad"

    def loss(sc, axis=None):
        return jtrain.batched_loss_fn(sc, *args, gauss_axis=axis)[0]

    jscene = posed(s)
    jgrad = jax.jit(jax.grad(loss))(jscene)
    jmesh = j_make_mesh([1, 4], ("scan", "gauss"), devices=jax.devices()[:4])
    specs = jax.tree.map(lambda l: P("gauss", *([None] * (l.ndim - 1))), jscene)
    jsharded = jax.jit(jax.shard_map(lambda sc: jax.grad(lambda q: loss(q, "gauss"))(sc),
                                     mesh=jmesh, in_specs=(specs,), out_specs=specs,
                                     check_vma=False))(jscene)

    def jsharded_g(field):
        return np.asarray(getattr(jsharded, field))

    ts = scene_from_numpy(scene_arrays(jscene), "cpu")
    tset = s["tset"]
    tl, _ = ttrain.batched_loss_fn(ts, torch.as_tensor(cams), torch.as_tensor(tgts),
                                   torch.as_tensor(np.asarray(s["box"])), s["data"].c,
                                   s["data"].deltaT, torch.as_tensor(consts(s)[3]),
                                   torch.zeros((), dtype=torch.int32), tset,
                                   OptimizationParams(regularization=reg))
    single = ttrain.param_grads(tl, ttrain.group_params(ts))
    for gi, g in enumerate(ttrain.GROUPS):
        field = ttrain.GROUP_FIELD[g]
        got = np.concatenate([r[case]["grads"][g] for r in world14])
        want = np.asarray(getattr(jgrad, field))
        scale = np.abs(want).max()
        if scale == 0:  # sh_rest at SH degree 0
            assert not got.any() and not single[gi].any() and not jsharded_g(field).any()
            continue
        print(f"{g}: sharded vs single {np.abs(got - single[gi].numpy()).max() / scale:.2e}, "
              f"vs JAX {np.abs(got - want).max() / scale:.2e}")
        assert np.abs(got - single[gi].numpy()).max() <= 1e-5 * scale, g
        assert np.abs(got - want).max() <= 1e-4 * scale, g
        np.testing.assert_allclose(np.asarray(getattr(jsharded, field)), 4 * want,
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=g)


def test_overflow_on_a_later_gauss_shard_is_raised(setup, world14):
    """Shard 0's rows dead, w_max 1: the other shards overflow. JAX's
    sharded step reduces the flag over `scan` only and returns shard 0's
    (False, a reference caveat; its single-device step says True); the
    port's reduces over both axes."""
    s = setup
    cams, tgts = batch(s, np.random.default_rng(0).integers(0, 16, size=4))
    alive = np.where(np.arange(32) < 8, 0.0, 1.0).astype(np.float32)
    jscene = dataclasses.replace(s["scene"], alive=jnp.asarray(alive))
    js = s["settings"]._replace(backend="pallas_rsort",
                                rsort_spec=JRSortSpec(**dict(RSPEC, w_max=1)))
    jargs = (jnp.asarray(cams), jnp.asarray(tgts), s["box"], s["data"].c, s["data"].deltaT,
             jnp.asarray(s["data"].volume_position))
    jmesh = j_make_mesh([1, 4], ("scan", "gauss"), devices=jax.devices()[:4])
    st0 = jtrain.create_train_state(jscene, s["tx"])
    step = j_sharded(jmesh, js, s["optim"], s["tx"], s["cfg"].sh_degree, st0, donate=False)
    _, jaux = step(j_shard_scene(st0, jmesh), *jargs)
    single = jtrain.make_train_step(js, s["optim"], s["tx"], s["cfg"].sh_degree,
                                    donate=False)
    _, jaux1 = single(jtrain.create_train_state(jscene, s["tx"]), *jargs)
    assert bool(jaux1.overflow) and not bool(jaux.overflow)
    assert all(r["overflow"]["overflow"] == [True] for r in world14)


def test_dryrun_multichip_4():
    """tests/test_graft_entry.py:6: one `pallas_rsort` sharded step and one
    sharded densify step on a (2, 2) mesh of 4 gloo ranks."""
    out = dryrun.dryrun_multichip(4, "gloo", device="cpu")
    assert out["mesh"] == [2, 2] and out["step"] == 2 and not out["overflow"]
    assert np.isfinite(out["loss"]) and out["alive_after"] >= out["alive_before"]


def test_spawn_fails_the_world_on_a_failing_rank():
    """A rank that raises fails `spawn` with its traceback (here `make_mesh`
    refusing sizes that do not cover the world) instead of hanging."""
    with pytest.raises(RuntimeError, match="does not cover 2 ranks"):
        launch.spawn(functools.partial(mesh.make_mesh, backend="gloo", device="cpu"), 2,
                     "gloo", 60, args=([3, 1],))


def test_backend_and_device_are_the_callers():
    """Every multi-device entry point takes the backend from its caller (no
    default), and the command line refuses to run without one."""
    import inspect

    for fn, name in ((mesh.make_mesh, "backend"), (launch.spawn, "backend"),
                     (dryrun.run_cases, "backend"), (dryrun.dryrun_multichip, "backend")):
        assert inspect.signature(fn).parameters[name].default is inspect.Parameter.empty, fn
    with pytest.raises(SystemExit):
        dryrun.main(["4"])
    with pytest.raises(SystemExit):
        dryrun.main(["4", "mpi"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_mesh_without_a_card_refuses_the_default_device():
    """Without `device`, a mesh puts its tensors on the card, also over
    gloo: with no card it raises instead of falling back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(functools.partial(mesh.make_mesh, backend="gloo"), 1, "gloo", 60)
