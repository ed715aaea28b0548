"""`pallas_dsort` on the card: K1-K4 on its lists and its duplicate gather.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_dsort_cuda.py -m cuda
--noconftest`.

  - at the bench scene's geometry with 5k Gaussians (`tools.bench_scene`,
    32x32 angles x 200 bins, the dsort caps tuned from `bench.py`'s 4x4-ray
    base), the centre camera's lists through K1 and K2 equal their plain
    versions exactly, K3 and K4 on the dsort table meet chip_smoke's gates
    (rel_l2 1e-5 and 1e-4 over visited blocks, zeros elsewhere), each
    launch equals the one before bit for bit, and the duplicate gather's
    backward is the same bit for bit twice and from a CUDA graph, within
    1e-6 of one `index_add_` relative to its norm;
  - a dsort chunk of 8 on the committed Zaragoza artifact at 5k Gaussians
    (`fit`'s settings) from its CUDA graph equals 8 eager steps bit for bit,
    and two eager runs of them equal each other.
"""

import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.ops.math import volume_box_points
from nlos_gaussian_renderer_tpu_torch.tools import (
    VOLUME_POSITION,
    VOLUME_SIZE,
    bench_scene,
    dsortbench,
    fitbench,
)

pytestmark = pytest.mark.cuda
K = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels and CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_dsort_lists_through_k1_k4_and_the_gather_equal_their_plain_versions(dev):
    scene = bench_scene(5_000, device=dev)[0]
    box = volume_box_points(VOLUME_POSITION, VOLUME_SIZE, device=dev)
    spec = dsortbench.tune(scene, box)
    out = dsortbench.kernels(scene, box, spec, torch.zeros(3, device=dev), dev)
    assert not out["overflowed"] and out["max_dups"] > 1 and out["n_items"] > 0
    assert out["k1_equal"] and out["k1_again_equal"]
    assert out["k2_equal"] and out["k2_again_equal"] and out["lists_equal_cull"]
    assert out["k3_rel_l2"] <= 1e-5 and out["k3_again_equal"]
    assert out["k4_rel_l2"] <= 1e-4 and out["k4_unvisited_zero"] and out["k4_again_equal"]
    assert out["dup_gather_again_equal"] and out["dup_gather_graph_equal"]
    assert out["dup_gather_vs_index_add_rel_l2"] <= 1e-6


def test_dsort_chunk_replay_equals_eager_bit_for_bit(dev):
    data = load_zaragoza256_data(fitbench.ARTIFACT)
    cfg = fitbench.config(data, renderer="pallas_dsort", gaussians=5_000)
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    assert settings.backend == "pallas_dsort"
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = fitbench._batches(cfg, data, K, dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    aux = chunk(state, cams, tgts, *consts)
    replayed = train.snapshot_state(state)
    assert not bool(aux.overflow) and chunk.captures == 1
    assert all(chunk.launches_per_replay.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS)
    eager = []
    for _ in range(2):
        train.restore_state(state, s0)
        losses = [step(state, cams[i], tgts[i], *consts).loss for i in range(K)]
        eager.append(train.snapshot_state(state))
        assert torch.equal(aux.loss, torch.stack(losses))
    assert fitbench._diffs(replayed, eager[0])[1] and fitbench._diffs(eager[0], eager[1])[1]
