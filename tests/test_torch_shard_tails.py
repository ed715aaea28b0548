"""The work-list renders keep only sub-cutoff tails that depend on the
blocks: a bound that holds for any block composition, so for the
Gaussian-sharded render and the unsharded one alike.

Let T[s] be the sum over Gaussians of |that Gaussian's contribution at
sample s|, taken only where s lies outside its cull sphere (radius
`sigma_cull * max scale * margin`, as `fused.angular_footprints` uses
it); for `pallas_analytic`, whose samples are bin integrals, where the
(ray, bin) segment misses the sphere. Every work-list render keeps each
term inside each sphere (the cull's tiles and bin ranges cover the
sphere) and some subset of the tails, so for any render R, sharded or
not,

    |R - exact| <= (1 + eta) T + F + 1e-6 peak,

with exact the uncut render in float64 (`mahalanobis_direct`, or the
analytic bin integrals), F = |R_uncut - exact| the backend's own f32
floor (the same kernels' plain versions with `sigma_cull` so large that
nothing is cut: the same terms in the same arithmetic), eta = max F / S
over the samples with S >= 1e-3 of the peak (S the sum of every term's
magnitude: the relative f32 error a term carries, which the tails carry
too) and 1e-6 of the peak for the f32 summation order. Between two
renders the difference is tails alone: |R_sharded - R_unsharded| <=
(1 + eta) T + 1e-6 peak.

Both scenes, at 4 Gaussian shards (contiguous rows, as
`sharding.shard_scene` splits them; the sharded render is the sum of the
shards' fields, `GaussSum`, which tests/test_torch_sharding.py holds to
the sum of the shards' own renders at rtol 1e-5 and which without
occlusion is the sum of their transients):

  - JAX's tests/test_sharding.py scene (32 Gaussians, sigma up to 29 cm,
    4x4 scan, 64 bins, ns 8, camera 3, `RSPEC` / `DSPEC`): eta 3e-6 to
    1.3e-5, F up to 2e-6 of the peak, T up to 8.3e-3 (7.2e-3 analytic);
    |R - exact| reaches 0.40-0.97 of its bound unsharded and 0.66-0.97
    sharded, and the gap between the two (1.5e-3 of the peak) 0.66-0.68
    of (1 + eta) T;
  - the bench scene at 2,000 Gaussians (numpy seed 0, sigma 2-12 mm, ns
    8, bins 100..300, the centre camera, 4x4-ray tiles, one radial chunk,
    caps tuned there): the f32 form of mm Gaussians ~1 m away is ~2% off
    float64 per term (eta 0.017, F up to 3.7e-3 of the peak, T up to
    2.5e-3), so |R - exact| is the floor F itself where T is 0 (1.000 of
    the bound); the sharded render is 2.2-2.6e-6 of the peak from the
    unsharded one, 0.41-0.48 of (1 + eta) T.

So the sharded render's gap (ROADMAP Queue 3) is the method's sub-cutoff
floor, not a fault. tests/test_torch_sharding.py holds the gloo world's
own sharded histograms to the same bound."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.analytic import (
    _ray_quadratics,
    bin_edges_from_grid,
    grid_dirs,
    section_bin_integrals,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused_dsort import tune_dsort_spec
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec, tune_rsort_spec
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import attenuation_weights, shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import bench_scene
from test_torch_sharding import consts, port_settings, scene_arrays, setup  # noqa: F401

torch.set_num_threads(1)
BACKENDS = ("pallas_rsort", "pallas_analytic", "pallas_dsort")
SHARDS = 4
UNCUT = 1e4  # a sigma_cull whose sphere holds the whole grid: nothing is cut
ORDER = 1e-6  # of the peak: the f32 summation order of two block layouts


def tail_terms(scene, cam, box, c, dt, vol, settings, sh_degree):
    """(exact, T, S) float64 over the (num_r * ns^2) transient: the uncut
    render, the tails outside each Gaussian's cull sphere, and the sum of
    every term's magnitude (without occlusion, with the render's
    attenuation and volume factor)."""
    spec = settings.rsort_spec
    grid = shell_grid(cam, box, settings.num_sampling_points, settings.start, settings.end,
                      c, dt)
    w = channel_weights(scene, cam, sh_degree, settings)[:, 0].detach().double()
    mu, scales, rot = (t.detach().double() for t in (scene.means, scene.scales,
                                                     scene.rotations))
    radius = spec.sigma_cull * spec.margin * scales.amax(1)
    if settings.backend == "pallas_analytic":
        dirs, edges = grid_dirs(grid).double(), bin_edges_from_grid(grid.r).double()
        camd = cam.double()
        a, b, cc = _ray_quadratics(mu, scales, rot, camd, dirs)
        terms = (section_bin_integrals(a, b, cc, edges) * w
                 / (edges[1:] - edges[:-1])[:, None, None])  # (K, R, N)
        # The closest point of each (ray, bin) segment to each mean.
        t = torch.clamp((dirs @ (mu - camd).T)[None], edges[:-1, None, None],
                        edges[1:, None, None])
        near = camd + t[..., None] * dirs[None, :, None, :]
        inside = (near - mu).norm(dim=-1) <= radius
        terms, inside = terms.flatten(0, 1), inside.flatten(0, 1)
    else:
        pts = grid.points.reshape(-1, 3).double()
        terms = torch.exp(-0.5 * gmath.mahalanobis_direct(pts, mu, scales, rot)) * w
        inside = (pts[:, None, :] - mu).norm(dim=-1) <= radius
    fac = attenuation_weights(grid).double().reshape(-1)
    if settings.apply_volume_y2_factor:
        fac = fac * float(vol[1]) ** 2
    return (terms.sum(1) * fac, (terms * ~inside).sum(1) * fac,
            terms.abs().sum(1) * fac)


def render(arrays, cam, box, c, dt, vol, settings, sh_degree):
    _, _, ov = out = render_transient(scene_from_numpy(arrays, "cpu"), cam, box, c, dt, vol,
                                      sh_degree, settings)
    assert not bool(ov)
    return out[0].detach().double().reshape(-1)


def uncut_spec(scene, cam, box, c, dt, settings):
    """The settings' spec with nothing cut, its caps tuned at `cam`."""
    tune = tune_dsort_spec if settings.backend == "pallas_dsort" else tune_rsort_spec
    return tune(scene, cam[None].numpy(), box, settings.num_sampling_points, settings.start,
                settings.end, c, dt, base=settings.rsort_spec._replace(sigma_cull=UNCUT))


def tail_bound(arrays, cam, box, c, dt, vol, settings, sh_degree):
    """(exact, T, bound, eta) of the docstring's bound, float64 per sample."""
    scene = scene_from_numpy(arrays, "cpu")
    exact, tails, mag = tail_terms(scene, cam, box, c, dt, vol, settings, sh_degree)
    uncut = render(arrays, cam, box, c, dt, vol,
                   settings._replace(rsort_spec=uncut_spec(scene, cam, box, c, dt, settings)),
                   sh_degree)
    floor = (uncut - exact).abs()
    peak = float(exact.abs().max())
    live = mag >= 1e-3 * peak
    eta = float((floor[live] / mag[live]).max())
    return exact, tails, (1 + eta) * tails + floor + ORDER * peak, eta


def shards(arrays):
    n = arrays["means"].shape[0] // SHARDS
    return [{f: v[i * n:(i + 1) * n] for f, v in arrays.items()} for i in range(SHARDS)]


def jax_scene_case(setup, backend):
    s = setup  # noqa: F811
    box, c, dt, vol = consts(s)
    cam = torch.as_tensor(np.asarray(s["data"].camera_grid_positions[:, 3], np.float32))
    return (scene_arrays(s["scene"]), cam, torch.as_tensor(box), c, dt, torch.as_tensor(vol),
            port_settings(s, backend), 1)


def bench_case(backend):
    scene, box, _ = bench_scene(2000, seed=0, device="cpu")
    cam = torch.zeros(3)
    base = RSortSpec(t_theta=4, t_phi=4, t_chunk=200, gate_bins=8)
    tune = tune_dsort_spec if backend == "pallas_dsort" else tune_rsort_spec
    spec = tune(scene, cam[None].numpy(), box, 8, 100, 300, 1.0, 0.0052, base=base)
    settings = RenderSettings(num_sampling_points=8, start=100, end=300, backend=backend,
                              rsort_spec=spec)
    arrays = {n: getattr(scene, n).detach().numpy() for n in FIELD_NAMES}
    return arrays, cam, box, 1.0, 0.0052, torch.tensor([0.0, 1.0, 0.0]), settings, 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scene", ["jax32", "bench2k"])
def test_sharded_and_unsharded_renders_differ_from_exact_by_tails_alone(setup, scene,  # noqa: F811
                                                                        backend):
    case = jax_scene_case(setup, backend) if scene == "jax32" else bench_case(backend)
    arrays, rest = case[0], case[1:]
    exact, tails, bound, eta = tail_bound(arrays, *rest)
    peak = float(exact.abs().max())
    assert eta < 0.05  # the f32 floor of one term: ~1% at mm sigmas 1 m away
    unsharded = render(arrays, *rest)
    sharded = sum(render(part, *rest) for part in shards(arrays))
    for name, got in (("unsharded", unsharded), ("sharded", sharded)):
        err = (got - exact).abs()
        assert bool((err <= bound).all()), (name, float(((err - bound) / peak).max()))
    gap = (sharded - unsharded).abs()
    assert bool((gap <= (1 + eta) * tails + ORDER * peak).all()), float(gap.max() / peak)
    if scene == "jax32":  # its sigmas reach 29 cm: the shards keep other tails
        assert float(gap.max()) > 1e-4 * peak
