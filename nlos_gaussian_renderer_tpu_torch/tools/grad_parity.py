"""Gradient parity of the `pallas_rsort` backward against a chunked dense
ground truth, at the 100k bench scene, on the card.

Port of `tools/grad_parity.py`. The scene is the bench's: 100k Gaussians
(numpy seed 0, sigma log-uniform 2-12 mm), 32x32 angles x 200 bins, the
rsort caps tuned on the three probe cameras.

Ground truth: the dense no-occlusion field summed over Gaussian chunks of
`--chunk`, each chunk recomputed in the backward (`torch.utils.checkpoint`),
so the (A, N) matrix never exists: `render_transient(backend="dense",
gauss_chunk=chunk)`, the function JAX's `loss_dense_chunked` computes (held
to `jax.grad` of it by tests/test_torch_tools.py). f32 matmuls stay f32
(TF32 off).

Per parameter group (means, log_scales, quats, logit_opacities, sh_dc),
worst over the three probe cameras:
  rel_l2   = ||g_rsort - g_dense|| / ||g_dense||
  max_norm = max|g_rsort - g_dense| / max|g_dense|
  cosine   = <g_rsort, g_dense> / (||g_rsort|| ||g_dense||)  (the smallest)
and the forward histogram's rel_l2 (worst camera).

Rows: `sigma3` (the bench's 3-sigma cull), `sigma5` (5-sigma: the cull's
truncation set apart from arithmetic), `gtnoise` (the ground truth against
itself at twice the chunk: its summation-order floor). JAX's `nogate`,
`bf16`, `masked`, `maskeq` and `xlaws` rows have no counterpart and raise
`ValueError`. `--fd` adds directional
finite differences at the centre camera, without JAX's eps = 0 "noise
floor" (it evaluates one input twice and is identically 0; `gtnoise` is
the floor). `--cpu` runs the plain versions on the CPU.

Writes `--out` (default build/grad_parity_100k_torch.json under the
checkout) and prints the same JSON as the last line of its output; logs go
to stderr.

    python -m nlos_gaussian_renderer_tpu_torch.tools.grad_parity [--rows sigma3,sigma5,gtnoise] [--fd]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    PROBE_CAMS,
    VOLUME_POSITION,
    bench_scene,
    device_name,
    resolve_device,
)

GROUPS = ("means", "log_scales", "quats", "logit_opacities", "sh_dc")
ROWS = ("sigma3", "sigma5", "gtnoise")
NO_COUNTERPART = {
    "nogate": "the port's kernels cover each item's exact bin range, so gate_bins "
              "changes nothing (it is only checked to divide t_chunk): the row "
              "would repeat sigma3",
    "bf16": "the port has no bf16 backward: it computes the field and its "
            "gradient in f32",
    "masked": "mask_dead_blocks is moot in the port: the backward output is "
              "zero-filled, so blocks no item visits are already zero",
    "maskeq": "mask_dead_blocks is moot in the port: the backward output is "
              "zero-filled, so the two gradients cannot differ",
    "xlaws": "the port's work lists always go through K1/K2: there is no XLA "
             "work-list builder to compare",
}
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "grad_parity_100k_torch.json"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--chunk", type=int, default=256,
                    help="dense ground-truth Gaussian chunk")
    ap.add_argument("--sigma-min", type=float, default=0.002)
    ap.add_argument("--sigma-max", type=float, default=0.012)
    ap.add_argument("--ns", type=int, default=32, help="angular grid side")
    ap.add_argument("--start", type=int, default=100)
    ap.add_argument("--end", type=int, default=300)
    ap.add_argument("--rows", default="sigma3,sigma5,gtnoise",
                    help=f"comma list of rows to measure, of {', '.join(ROWS)}")
    ap.add_argument("--gate-bins", type=int, default=8)
    ap.add_argument("--t-chunk", type=int, default=0,
                    help="0 = one chunk covering all bins")
    ap.add_argument("--fd", action="store_true",
                    help="directional finite differences of both forwards along "
                         "each group's two gradient directions (centre camera)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    for r in rows:
        if r in NO_COUNTERPART:
            raise ValueError(f"row {r!r} has no counterpart in the port: {NO_COUNTERPART[r]}")
        if r not in ROWS:
            raise ValueError(f"unknown row {r!r}; rows are {', '.join(ROWS)}")
    args.rows = rows
    return args


def _cmp(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    rel = float((a - b).norm() / (b.norm() + 1e-30))
    mx = float((a - b).abs().max() / (b.abs().max() + 1e-30))
    cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
    return rel, mx, cos


class Problem:
    """The tool's scene and loss: the bench scene (numpy seed 0, log-uniform
    sigma in [sigma_min, sigma_max]), the box, and a random target
    histogram, drawn in the JAX tool's order. `dense` is the ground truth's
    settings; `rsort(spec)` the measured backend's."""

    def __init__(self, gaussians=100_000, sigma_min=0.002, sigma_max=0.012, ns=32,
                 start=100, end=300, device="cuda"):
        from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

        dev = resolve_device(device)
        self.scene, self.box, rng = bench_scene(gaussians, sigma=(sigma_min, sigma_max),
                                                device=dev)
        self.vol = torch.as_tensor(VOLUME_POSITION, device=dev)
        self.target = torch.as_tensor(rng.random(end - start).astype(np.float32), device=dev)
        self.cams = torch.as_tensor(PROBE_CAMS, device=dev)
        self.params = dict(self.scene.named_parameters())
        self.dense = RenderSettings(num_sampling_points=ns, start=start, end=end,
                                    backend="dense")

    def rsort(self, spec):
        return self.dense._replace(backend="pallas_rsort", rsort_spec=spec)

    def loss(self, settings, cam, chunk=None):
        """(MSE, histogram, overflow) of one scan point."""
        from nlos_gaussian_renderer_tpu_torch.ops.render import mse_loss, render_transient

        _, hist, ovf = render_transient(self.scene, cam, self.box, C_LIGHT, DELTA_T,
                                        self.vol, 0, settings, gauss_chunk=chunk)
        return mse_loss(hist, self.target)[0], hist, ovf

    def grads(self, settings, cam, chunk=None):
        """({group: gradient of the MSE}, histogram, overflow)."""
        self.scene.zero_grad(set_to_none=True)
        value, hist, ovf = self.loss(settings, cam, chunk)
        value.backward()
        return ({g: self.params[g].grad.detach().clone() for g in GROUPS},
                hist.detach(), ovf)

    def tune(self, base):
        from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import tune_rsort_spec

        st = self.dense
        return tune_rsort_spec(self.scene, PROBE_CAMS, self.box, st.num_sampling_points,
                               st.start, st.end, C_LIGHT, DELTA_T, base=base)


def main(argv=None):
    """Measure the rows; returns the JSON record (also written and printed)."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {device_name(dev)}")
    ns, start, end = args.ns, args.start, args.end
    p = Problem(args.gaussians, args.sigma_min, args.sigma_max, ns, start, end, dev)

    t0 = time.time()
    gate_bins = args.gate_bins
    t_chunk = args.t_chunk or -(-(end - start) // gate_bins) * gate_bins
    base = RSortSpec(t_chunk=t_chunk, gate_bins=gate_bins)
    spec3 = p.tune(base)
    log(f"tuned sigma_cull=3 caps: max_groups={spec3.max_groups} w_max={spec3.w_max} "
        f"({time.time() - t0:.0f}s)")
    spec5 = None
    if "sigma5" in args.rows:
        spec5 = p.tune(base._replace(sigma_cull=5.0))
        log(f"tuned sigma_cull=5 caps: max_groups={spec5.max_groups} w_max={spec5.w_max}")

    t0 = time.time()
    truth = [p.grads(p.dense, cam, args.chunk)[:2] for cam in p.cams]
    log(f"chunked-dense ground truth done in {time.time() - t0:.0f}s (chunk={args.chunk})")

    def measure(spec, tag):
        rows = {g: {"rel_l2": 0.0, "max_norm": 0.0, "cosine": 1.0} for g in GROUPS}
        hist_rel = 0.0
        for i, cam in enumerate(p.cams):
            gr, hist, ovf = p.grads(p.rsort(spec), cam)
            if bool(ovf):
                # A saturated capacity truncates the field: the number would
                # measure the truncation, not the kernels.
                raise RuntimeError(f"culling capacity overflow at cam {i} under {tag}: "
                                   "re-tune the caps before measuring parity")
            gd, hd = truth[i]
            hist_rel = max(hist_rel, _cmp(hist, hd)[0])
            for g in GROUPS:
                rel, mx, cos = _cmp(gr[g], gd[g])
                r = rows[g]
                r["rel_l2"], r["max_norm"] = max(r["rel_l2"], rel), max(r["max_norm"], mx)
                r["cosine"] = min(r["cosine"], cos)
        rows["_forward_hist"] = {"rel_l2": hist_rel}
        log(f"[{tag}] forward hist rel_l2 (worst cam): {hist_rel:.3e}")
        log(f"[{tag}] " + "  ".join(
            f"{g}: l2={rows[g]['rel_l2']:.2e} max={rows[g]['max_norm']:.2e} "
            f"cos={rows[g]['cosine']:.7f}" for g in GROUPS))
        return rows

    out = {
        "scene": {"gaussians": args.gaussians, "angular_grid": [ns, ns],
                  "bins": [start, end], "sigma_range_m": [args.sigma_min, args.sigma_max],
                  "probe_cams": PROBE_CAMS.tolist()},
        "ground_truth": (f"dense no-occlusion field, render_transient(backend='dense', "
                         f"gauss_chunk={args.chunk}), f32 matmuls (TF32 off), "
                         "torch.utils.checkpoint per chunk"),
        "metrics": {
            "rel_l2": "||g_rsort-g_dense||_2 / ||g_dense||_2, worst of 3 cams",
            "max_norm": "max|g_rsort-g_dense| / max|g_dense|, worst of 3 cams",
            "cosine": "<g_rsort, g_dense> / (||g_rsort|| ||g_dense||), smallest of 3 cams",
        },
        "device": device_name(dev),
        "caps": {"t_chunk": spec3.t_chunk, "gate_bins": spec3.gate_bins,
                 "w_max": spec3.w_max, "max_groups": spec3.max_groups},
        "rows": {},
    }
    if "gtnoise" in args.rows:
        noise = {g: 0.0 for g in GROUPS}
        for i, cam in enumerate(p.cams):
            g2, _, _ = p.grads(p.dense, cam, 2 * args.chunk)
            for g in GROUPS:
                noise[g] = max(noise[g], _cmp(g2[g], truth[i][0][g])[0])
        log("[gtnoise] dense ground truth vs itself at chunk x2, worst cam: "
            + "  ".join(f"{g}: {noise[g]:.2e}" for g in GROUPS))
        out["rows"]["dense_gt_self_noise_chunk_x2"] = {g: {"rel_l2": v} for g, v in noise.items()}
    if "sigma3" in args.rows:
        out["rows"]["f32_sigma3"] = measure(spec3, "f32, sigma_cull=3 (bench config)")
    if "sigma5" in args.rows:
        out["rows"]["f32_sigma5"] = measure(spec5, "f32, sigma_cull=5 (truncation set apart)")
    if args.fd:
        out["fd_arbitration_cam1"] = finite_differences(p, spec3, args.chunk, truth[1][0])

    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    log(f"wrote {path}")
    print(json.dumps(out), flush=True)
    return out


def finite_differences(p: Problem, spec, chunk, gd):
    """Directional arbitration at the centre camera: for each group, central
    differences of BOTH forwards (dense at `chunk`, rsort at `spec`) along
    the dense (`gd`) and the rsort gradient's directions, beside each
    analytic gradient's prediction <g, v>. If both forwards' differences
    match one prediction and not the other, the other backward is wrong."""
    cam, dense, rsort, loss = p.cams[1], p.dense, p.rsort(spec), p.loss
    gr, _, _ = p.grads(rsort, cam)
    with torch.no_grad():
        log(f"[fd] L_dense={float(loss(dense, cam, chunk)[0]):.8e} "
            f"L_rsort={float(loss(rsort, cam)[0]):.8e}")
    @torch.no_grad()
    def losses_at(param, value):
        """(dense loss, rsort loss, rsort overflow) with `param` set to
        `value`; the parameter is restored after."""
        x = param.detach().clone()
        param.copy_(value)
        ld, (lr, _, ovf) = float(loss(dense, cam, chunk)[0]), loss(rsort, cam)
        param.copy_(x)
        return ld, float(lr), bool(ovf)

    record = {}
    for name in GROUPS:
        param = p.params[name]
        x = param.detach().clone()
        a, b = gr[name].double(), gd[name].double()
        na, nb = float(a.norm()), float(b.norm())
        cos = float((a * b).sum() / (na * nb + 1e-30))
        log(f"[fd:{name}] ||g_dense||={nb:.4e} ||g_rsort||={na:.4e} cos={cos:+.4f}")
        record[name] = {"norm_dense": nb, "norm_rsort": na, "cos": cos, "dirs": {}}
        for tag, g in (("gdense", b), ("grsort", a)):
            v = (g / (g.norm() + 1e-30)).to(torch.float32)
            pred_d, pred_r = float((b * v).sum()), float((a * v).sum())
            drec = {"pred_dense": pred_d, "pred_rsort": pred_r, "eps": {}}
            record[name]["dirs"][tag] = drec
            for eps in (3e-3, 1e-3):
                lpd, lpr, ovp = losses_at(param, x + eps * v)
                lmd, lmr, ovm = losses_at(param, x - eps * v)
                if ovp or ovm:
                    log(f"[fd:{name}] WARNING: culling overflow at a perturbed point "
                        f"(dir={tag} eps={eps:.0e}): the rsort row is truncated")
                fd_d, fd_r = (lpd - lmd) / (2 * eps), (lpr - lmr) / (2 * eps)
                log(f"[fd:{name}] dir={tag} eps={eps:.0e} fd_dense={fd_d:+.6e} "
                    f"fd_rsort={fd_r:+.6e} pred_dense={pred_d:+.6e} pred_rsort={pred_r:+.6e}")
                drec["eps"][f"{eps:.0e}"] = {"fd_dense": fd_d, "fd_rsort": fd_r}
    return record


if __name__ == "__main__":
    main()
