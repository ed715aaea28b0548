"""The reference's densify event and the check of the program's donors, on
the CPU at 2,000 slots: the event against the port's `densify_step` given
the same draws, the donors recovered from the port's state, and
`donor_gap` for sound draws and for draws under another key."""

from __future__ import annotations

import pytest
import torch

from benchmark import donors, inputs, reference
from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.models import densify
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops import random as prng

CONFIG = dict(scan_grid=[8, 8], start=160, end=200, num_sampling_points=8, sh_degree=3)
SEED, COUNTER, CAP = 77, 5300, 100_000


def population(alive=1600, slots=2000, seed=11):
    """2,000 slots, `alive` alive, every 50th at opacity 0.001, the rest's
    opacities spread so that donors weigh differently."""
    traffic = dict(sigma=[0.03, 0.07], alive=alive, slots=slots, start_step=5250, max_steps=1,
                   population_seed=3, near_dead=dict(every=50, opacity=0.001))
    p = inputs.make_inputs(CONFIG, traffic, seed, "cpu", chunk=64)["params"]
    g = torch.Generator().manual_seed(seed)
    spread = 0.5 * torch.randn(alive, 1, generator=g)
    spread[::50] = 0.0
    p["logit_opacities"][:alive] += spread
    return p


def moments(p, seed=5):
    g = torch.Generator().manual_seed(seed)
    mu = {k: torch.randn(p[k].shape, generator=g) for k in reference.GROUPS}
    nu = {k: torch.rand(p[k].shape, generator=g) for k in reference.GROUPS}
    return mu, nu


def port_event(p, mu, nu, draw=None):
    """The port's `densify_step` on copies; returns (params, mu, nu, the
    donors it drew by phase)."""
    scene = GaussianScene(*(p[n].clone() for n in FIELD_NAMES))
    state = train.create_train_state(scene, train.make_optimizer(train.OptimizationParams()))
    field_of = dict(zip(train.GROUPS, ("means", "sh_dc", "sh_rest", "logit_opacities",
                                       "log_scales", "quats")))
    for i, g in enumerate(train.GROUPS):
        state.opt_state.mu[i].copy_(mu[field_of[g]])
        state.opt_state.nu[i].copy_(nu[field_of[g]])
    drawn = {}

    def recording(probs, which):
        d = (draw or (lambda pr, w: prng.categorical(pr, SEED, torch.tensor(COUNTER), lane=w)))(
            probs, which)
        drawn[which] = d.clone()
        return d

    densify.densify_step(state.scene, state.opt_state, SEED, torch.tensor(COUNTER), CAP,
                         draw=recording)
    params = {n: getattr(state.scene, n).detach().clone() for n in FIELD_NAMES}
    m = {field_of[g]: t.clone() for g, t in zip(train.GROUPS, state.opt_state.mu)}
    v = {field_of[g]: t.clone() for g, t in zip(train.GROUPS, state.opt_state.nu)}
    return params, m, v, drawn


def ref_event(p, mu, nu, drawn, dtype=torch.float32):
    q = {k: v.to(dtype).clone() for k, v in p.items()}
    m = {k: v.to(dtype).clone() for k, v in mu.items()}
    v = {k: t.to(dtype).clone() for k, t in nu.items()}
    rows = reference.densify_event(q, m, v, CAP, lambda which, w, t: drawn[which])
    return q, m, v, rows


def test_the_reference_event_matches_the_port_given_the_same_draws():
    p = population()
    mu, nu = moments(p)
    prog, pmu, pnu, drawn = port_event(p, mu, nu)
    r32, m32, v32, rows = ref_event(p, mu, nu, drawn)
    r64, m64, v64, rows64 = ref_event(p, mu, nu, drawn, torch.float64)
    assert int(rows["relocated"].sum()) == 32  # 1,600 alive, every 50th near dead
    # int(f32(1.05) x f32(1,600)) - 1,600: the float32 product is 1,679.9999
    assert int(rows["revived"].sum()) == 79
    assert torch.equal(rows["revived"], rows64["revived"])
    for k in ("means", "quats", "sh_dc", "sh_rest", "alive"):
        assert torch.equal(prog[k], r32[k]), k
    for k in ("logit_opacities", "log_scales"):
        # both float32 results within a few ulps of the float64 rule
        for got in (prog[k], r32[k]):
            err = (got.double() - r64[k]).abs().max()
            assert float(err) <= 1e-6 * max(float(r64[k].abs().max()), 1.0), k
    for k in reference.GROUPS:
        zero_p, zero_r = pmu[k] == 0, m32[k] == 0
        assert torch.equal(zero_p, zero_r) and torch.equal(pnu[k] == 0, v32[k] == 0), k
        assert torch.equal(m32[k][~zero_r], mu[k][~zero_r]), k


def test_donor_recovery_returns_the_injected_donors():
    """Donors injected into the port's event (growth donors kept off the
    relocated rows and their donors) are recovered exactly from its state;
    with a clone of a relocated row among them, the recovered donors give
    the reference the same state, bit for bit."""
    p = population()
    mu, nu = moments(p)
    alive = p["alive"] > 0.5
    n = p["alive"].shape[0]
    dead_rows = torch.arange(0, 1600, 50)
    g = torch.Generator().manual_seed(3)
    reloc = torch.randint(1, 1600, (n,), generator=g)
    reloc[reloc % 50 == 0] += 1
    taken = set(reloc[dead_rows].tolist()) | set(dead_rows.tolist())
    free = torch.tensor([j for j in range(1600) if j not in taken])
    grow = free[torch.randint(0, len(free), (n,), generator=g)]
    for mixed in (False, True):
        if mixed:
            grow = grow.clone()
            grow[1600:1603] = dead_rows[:3]  # clones of relocated rows
        inject = {0: reloc, 1: grow}
        prog, _, _, _ = port_event(p, mu, nu, draw=lambda probs, which: inject[which])
        ref = dict(params=p, mu=mu, nu=nu)
        got = donors.with_event(ref, dict(cap_max=CAP), COUNTER, prog, SEED)
        assert got["event"] == dict(relocated=32, revived=79, targets=111, recovered=111,
                                    revived_as_rule=True)
        want, _, _, _ = ref_event(p, mu, nu, inject)
        for k in FIELD_NAMES:
            assert torch.equal(got["params"][k], want[k]), (mixed, k)
        rec = donors.Recovered(prog, SEED, COUNTER)
        w0 = torch.where(alive, torch.sigmoid(p["logit_opacities"][:, 0]), 0.0)
        w0[dead_rows] = 0.0
        dead = torch.zeros(n, dtype=torch.bool)
        dead[dead_rows] = True
        assert torch.equal(rec(0, w0, dead)[dead], reloc[dead])
        if not mixed:
            revive = ~alive & (torch.cumsum((~alive).long(), 0) <= 79)
            w1 = torch.where(alive, torch.sigmoid(want["logit_opacities"][:, 0]), 0.0)
            assert torch.equal(rec(1, w1, revive)[revive], grow[revive])


@pytest.mark.parametrize("key_shift", [0, 1])
def test_donor_gap_reads_round_off_for_sound_draws(key_shift):
    """The port draws at one key from weights that differ from the
    reference's by round-off: `donor_gap` reads round-off at the same key
    and half a mean weight or more at the next one."""
    p = population()
    mu, nu = moments(p)
    prog, _, _, _ = port_event(p, mu, nu, draw=lambda probs, which: prng.categorical(
        probs, SEED, torch.tensor(COUNTER + key_shift), lane=which))
    g = torch.Generator().manual_seed(9)
    q = dict(p, logit_opacities=p["logit_opacities"]
             * (1 + 1e-6 * torch.randn(p["logit_opacities"].shape, generator=g)))
    got = donors.with_event(dict(params=q, mu=mu, nu=nu), dict(cap_max=CAP), COUNTER, prog,
                            SEED)
    assert got["event"]["recovered"] == got["event"]["targets"] == 111
    if key_shift == 0:
        assert got["donor_gap"] < 1e-3
    else:
        assert got["donor_gap"] >= 0.5


def test_the_event_falls_after_the_checked_chunk():
    optim = dict(mcmc_densification_flag=True, densify_from_iter=500,
                 densify_until_iter=25_000, densification_interval=100)
    assert donors.event_counter(optim, 5250, 50) == 5300
    assert donors.event_counter(optim, 25_001, 50) is None
    with pytest.raises(ValueError):
        donors.event_counter(optim, 5280, 50)
    assert donors.uniform64(SEED, COUNTER, 1000, 1).equal(
        prng.uniform64(SEED, torch.tensor(COUNTER), 1000, 1))
