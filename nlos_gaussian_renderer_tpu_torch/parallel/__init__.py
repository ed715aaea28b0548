"""Multi-device training over `torch.distributed`: scan-point data
parallelism x Gaussian sharding (port of `nlos_gaussian_renderer_tpu/parallel`).

  - `mesh.make_mesh`: a (scan, gauss) grid of ranks and its process groups;
  - `sharding`: the sharded train step, its K-step chunk and the sharded
    densify step;
  - `launch.spawn`: run a function on a local world of processes;
  - `dryrun.dryrun_multichip`: one sharded step and one sharded densify
    step on a synthetic set, the counterpart of `__graft_entry__.py`'s.
"""
