"""fdapde-core-tpu-torch: the PyTorch/CUDA port of `fdapde_core_tpu`.

The JAX package beside this one is the reference; this package reproduces
its public names and layout module for module (``ops/grid_dia.py`` <->
``ops/grid_dia.py``, ...) and is held against it by the tests in
``tests/test_torch_*.py``.

Conventions:

- plain functions on tensors, dataclasses of tensors where JAX used pytrees,
- every function takes its dtype and device from its arguments or inputs:
  there is no global precision switch (JAX's x64 flag has no counterpart),
  and every entry point that creates tensors runs on the card unless the
  caller asks for the CPU (``device=``, default ``"cuda"``; without a card
  that default raises, it never falls back),
- hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
  at first use (``_build.py``); on CPU tensors every kernel wrapper runs its
  plain PyTorch version instead, so importing the package and running it on
  the CPU never needs a GPU toolchain.

Ported so far: the device-scale structured Poisson path
(``models.StructuredPoisson``) and the fused coords->stencil assembly
kernel it runs (``ops/assembly_kernels.py``, ``csrc/p1_stencil.cu``); the
general-mesh gather path (``models.MatrixFreePoisson``,
``models.MatrixFreeElliptic`` with ``gather_kernel="xla"`` or ``"lane"``)
and the ELL gather SpMV kernel it runs (``ops/gather_spmv.py``,
``csrc/ell_spmv.cu``); the general-mesh PDE API (``PDE`` over a
``Triangulation`` and ``FEMSpace``, ``fem/assembler.py``,
``linear_algebra/sparse.py``, ``fem/solvers.solve_elliptic``) and the
closed-form P1 local-stiffness kernels it runs (``ops/local_stiffness.py``,
``csrc/p1_local_stiffness.cu``); DIA storage (``fem/assembler.assemble_dia``,
``linear_algebra/dia.py``) and the DIA SpMV kernel its products run
(``ops/dia_spmv.py``, ``csrc/dia_spmv.cu``); and the coords->off-diagonal
planes kernel, the fused assembly's first stage
(``ops/assembly_kernels.p1_offdiag_planes_from_coords``); and the
data-fitting path: point location (``geometry/point_location.py``), basis
evaluation (``fem/evaluation.py``), B-splines (``splines/``),
``models.SmoothingRegression`` and ``models.SpaceTimeSmoothing``, which run
K2 for every sparse product and K6 in their penalties' assembly; and the
solver breadth beyond the linear solve: ``fem.nonlinear.solve_semilinear``
(Newton with a BFGS fallback), ``fem.neumann``, the differentiable CG
(``linear_algebra.cg_differentiable``; K2 products carry a backward),
FSPAI and its recovery rung, ``fields``, ``optimization``,
``linear_algebra.block`` / ``binary``, ``utils.integration`` and the native
host library (``native/``: the first-encounter hash pass, FSPAI and RCM,
g++ at first use); and the multi-device layer (``parallel/`` over
``torch.distributed``: ``ShardedPoisson``, the halo solvers, the sharded
multigrid and space-time CG; ``models.solve_elliptic_sharded``), which
runs K2, K6 and K7 inside each shard.
"""

from . import (
    fem,
    fields,
    geometry,
    linear_algebra,
    models,
    native,
    ops,
    optimization,
    parallel,
    pde,
    splines,
    utils,
)
from .fem import FEMSpace
from .geometry import Interval, LinearNetwork, Triangulation
from .pde import PDE, advection, bilaplacian, diffusion, dt, laplacian, reaction

__version__ = "0.1.0"
