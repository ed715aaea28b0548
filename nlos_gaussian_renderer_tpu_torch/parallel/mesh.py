"""A (scan, gauss) mesh of `torch.distributed` ranks.

Port of `nlos_gaussian_renderer_tpu/parallel/mesh.py`. The `scan` axis is
data parallelism over confocal scan points: gradients are averaged over it,
one collective a step. The `gauss` axis shards the Gaussian population:
each rank renders its rows' partial field, and the per-sample fields are
summed over it (exact for every mode: each per-sample field is a sum of
per-Gaussian terms).

Rank r sits at (scan, gauss) = divmod(r, n_gauss), the numpy reshape order
of JAX's device array. The backend and the device are the caller's
choice and are never switched: NCCL with one GPU a rank, or gloo (CPU
tensors, or CUDA tensors staged through the host); the rank's tensors
live on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's view of the mesh."""

    sizes: tuple  # (n_scan, n_gauss)
    names: tuple  # ("scan", "gauss")
    coords: tuple  # (scan index, gauss index) of this rank
    scan_group: object  # the ranks of this rank's gauss index, along scan
    gauss_group: object  # the ranks of this rank's scan index, along gauss
    device: torch.device  # where this rank's tensors live
    backend: str

    @property
    def n_scan(self) -> int:
        return self.sizes[0]

    @property
    def n_gauss(self) -> int:
        return self.sizes[1]

    @property
    def scan_idx(self) -> int:
        return self.coords[0]

    @property
    def gauss_idx(self) -> int:
        return self.coords[1]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("scan", "gauss"), *, backend: str,
              device=None) -> Mesh:
    """The mesh over the initialised default group (`launch.spawn` sets it
    up). `axis_sizes` defaults to every rank on `scan`; `backend` must be
    the default group's. Every rank creates every scan group and every
    gauss group, in the same order (`new_group` is collective), and warms
    each group (and the default one) with one all-reduce, so a step's first
    collectives, or its capture into a CUDA graph, find their communicators
    made. `device` defaults to the card `cuda:(rank % cards)`, on either
    backend (`device="cpu"` for CPU tensors over gloo); without a card
    that default raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or launch.spawn)")
    if dist.get_backend() != backend:
        raise ValueError(f"the default group runs {dist.get_backend()!r}, not {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    names = tuple(axis_names)
    sizes = (world,) + (1,) * (len(names) - 1) if axis_sizes is None else tuple(axis_sizes)
    if len(sizes) != 2 or len(names) != 2:
        raise ValueError(f"a mesh has two axes (scan, gauss), got {names} of {sizes}")
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {sizes} does not cover {world} ranks")
    ranks = np.arange(world).reshape(sizes)
    scan_groups = [dist.new_group(ranks[:, j].tolist(), backend=backend)
                   for j in range(sizes[1])]
    gauss_groups = [dist.new_group(ranks[i, :].tolist(), backend=backend)
                    for i in range(sizes[0])]
    si, gi = (int(v) for v in np.unravel_index(rank, sizes))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a mesh of CPU tensors")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    for group in (None, scan_groups[gi], gauss_groups[si]):
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    return Mesh(sizes=sizes, names=names, coords=(si, gi), scan_group=scan_groups[gi],
                gauss_group=gauss_groups[si], device=device, backend=backend)
