"""The CLI slice on the card: the `pallas` row gather's backward run to run,
the carving vote, and a checkpoint of a card state.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_cli_cuda.py -m cuda
--noconftest`. Tolerance 0 throughout:
  - `fused.TakeRows`' backward, five calls eagerly and five replays of a
    CUDA graph of it, on 32 tiles of 1024 slots over 2,000 rows (every row
    in most tiles): bit for bit (and one float-atomic `index_add_` of the
    same rows within the f32 bound of two summation orders);
  - the carving vote on the Zaragoza artifact at 32^3 voxels x 4,096 scan
    points: the card's counts equal the CPU's;
  - a card state's checkpoint restored onto a card template: every tensor
    bit for bit, `alive` and both Adam moments included."""

import os

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.scene import init_scene
from nlos_gaussian_renderer_tpu_torch.ops import fused
from nlos_gaussian_renderer_tpu_torch.utils.carving import carving_inputs, carving_votes
from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

pytestmark = pytest.mark.cuda
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "data", "zaragoza64_bunny.mat")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the card's atomics have no CPU mode)")
    return torch.device("cuda")


def gather_lists(dev, rows=2000, t=32, k=1024, cols=20, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(k // 2, k + 1, size=t).astype(np.int32)
    idx = rng.integers(0, rows, size=(t, k)).astype(np.int32)
    for ti, n in enumerate(counts):
        idx[ti, :n] = np.sort(rng.permutation(rows)[:n])
    table = torch.as_tensor(rng.normal(size=(rows, cols)).astype(np.float32), device=dev)
    go = torch.as_tensor(rng.normal(size=(t, k, cols)).astype(np.float32), device=dev)
    return table, torch.as_tensor(idx, device=dev), torch.as_tensor(counts, device=dev), go


def test_take_rows_backward_is_bit_for_bit_eager_and_from_a_graph(dev):
    table, idx, counts, go = gather_lists(dev)
    leaf = table.clone().requires_grad_(True)

    def grad():
        out = fused.take_rows(leaf, idx, counts)
        return torch.autograd.grad(out, leaf, go)[0]

    eager = [grad() for _ in range(5)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = grad()
    replays = []
    for _ in range(5):
        graph.replay()
        replays.append(static.clone())
    torch.cuda.synchronize()
    graph.reset()
    for g in eager[1:] + replays:
        assert torch.equal(g, eager[0])
    # One float-atomic `index_add_` of the same rows sums them in some other
    # order: within the f32 bound of two summation orders of a row's n <= 32
    # addends, 2 (n - 1) 2^-24 sum |x|.
    valid = torch.arange(idx.shape[1], device=dev)[None, :] < counts[:, None]
    rows = idx[valid].long()
    one_call = torch.zeros_like(table).index_add_(0, rows, go[valid])
    abs_sum = torch.zeros_like(table).index_add_(0, rows, go[valid].abs())
    bound = 2 * (idx.shape[0] - 1) * 2.0**-24 * abs_sum
    assert bool(((eager[0] - one_call).abs() <= bound).all())


def test_carving_votes_card_equal_cpu(dev):
    coords, cams, radii = carving_inputs(load_zaragoza256_data(ARTIFACT), 32)
    card = carving_votes(*(torch.as_tensor(a, device=dev) for a in (coords, cams, radii)))
    cpu = carving_votes(*(torch.as_tensor(a) for a in (coords, cams, radii)))
    assert card.dtype == torch.int32 and card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)
    assert int(cpu.max()) > int(cpu.min())


def test_checkpoint_of_a_card_state_round_trips_bit_for_bit(dev, tmp_path):
    rng = np.random.default_rng(3)
    n = 5000
    scene = init_scene(rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                       rng.uniform(0, 1, (n, 1)).astype(np.float32),
                       [-0.3] * 3, [0.3] * 3, max_sh_degree=3, device=dev)
    state = train.create_train_state(scene, OptimizationParams())
    with torch.no_grad():
        for t in train.state_tensors(state)[:-3]:
            t.copy_(torch.randn(t.shape, generator=torch.Generator(dev).manual_seed(t.numel()),
                                device=dev))
        state.scene.alive.copy_((torch.rand(n, device=dev) > 0.4).float())
        state.opt_state.count.fill_(123)
        state.step.fill_(124)
        state.active_sh_degree.fill_(2)
    target = save_checkpoint(str(tmp_path), state)
    template = train.create_train_state(
        init_scene(np.zeros((n, 3), np.float32), np.zeros((n, 1), np.float32),
                   [-0.3] * 3, [0.3] * 3, max_sh_degree=3, device=dev), OptimizationParams())
    restored = restore_checkpoint(target, template)
    for a, b in zip(train.state_tensors(restored), train.state_tensors(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
