"""amg_tpu_torch — the PyTorch/CUDA port of amg_tpu for NVIDIA Hopper (H100).

The JAX package `amg_tpu` is the reference; this package mirrors its layout
(`amg_tpu_torch/solve/struct_cycle.py` <-> `amg_tpu/solve/struct_cycle.py`,
and so on) and imports nothing of it. Host setup is numpy/scipy in float64;
device state is torch tensors. Every Pallas kernel of the reference becomes a
CUDA C++ kernel written for sm_90a (`csrc/`), built at first use by
`ops/_build.py`, with a plain PyTorch version beside it that the CPU runs.

The generic (algebraic) path runs no custom kernel, as in the reference;
its host setup uses the port's copy of the reference's native setup library
(`native/amg_setup.cpp`, built with g++ by `native_backend.py`).

The drivers are the entry point a user calls, as in the reference:
`utils.runner.run_experiment(utils.config.SolverOptions(...))` runs one
configuration (problem, hierarchy, solver, stats) and
`python -m amg_tpu_torch.utils.cli` takes the reference's flags (and
`-device cpu|cuda`). Beneath them (`setup.structured.
build_structured_hierarchy`, `solve.struct_cycle.struct_solve`,
`solve.struct_cycle.struct_timed_cycles`;
`setup.structured.build_dia_structured_hierarchy`, `solve.mixed.mixed_pcg`
for the elasticity path; `setup.hierarchy.build_hierarchy`,
`solve.driver.solve` and `solve.driver.cheby_setup` for the generic path)
every entry point runs on the CUDA device unless the caller passes
`device="cpu"`.

`parallel/` runs the row-partitioned multi-device path over a mesh of D
logical shards (`parallel.dist.make_row_mesh`), in one process or spread
over the processes of a torch.distributed group; no kernel runs there, as
in the reference.
"""
