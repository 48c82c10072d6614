"""Multi-device execution over ``torch.distributed``: mesh partitioning,
element-sharded assembly and CG, halo-exchange solvers.

Port of ``fdapde_core_tpu/parallel``. JAX runs each solver as one
``shard_map`` region over a 1D mesh axis; here one process runs one shard
and ``comm.ShardMesh`` gives the region's three collectives (halo strips,
psum, all_gather) over NCCL on the card or gloo on the CPU:

- ``partition.py``: Morton element ordering and equal-size block
  partitioning with padding; ``reorder.py``: RCM dof reordering;
- ``sharded.py``: ``ShardedPoisson``, element-sharded assembly (K6 on the
  2D P1 Laplacian) and a replicated-vector CG, one psum per product;
- ``halo.py`` (DIA, K7), ``halo_ell.py`` and ``halo_lane.py`` (ELL, K2),
  ``halo_grid.py`` (stencils): owned-dof row blocks with halo strips;
- ``mg.py`` and ``banded.py``: the row-sharded V-cycle with a replicated
  coarse tail; ``space_time.py``: the time-sharded Kronecker CG;
- ``dryrun.py``: the 1-vs-N dry run and the gloo CPU launcher.

Every solver returns the full, unpadded solution on every rank.
"""

from .comm import ShardMesh, close_world, init_world, make_device_mesh
from .halo import HaloDIAParabolic, HaloDIASolver
from .halo_ell import HaloELLSolver
from .halo_grid import HaloGridDIASolver
from .halo_lane import HaloLaneSolver
from .partition import morton_order, partition_elements
from .sharded import ShardedPoisson
from .space_time import ShardedSpaceTime

__all__ = [
    "HaloDIAParabolic",
    "HaloDIASolver",
    "HaloELLSolver",
    "HaloGridDIASolver",
    "HaloLaneSolver",
    "ShardMesh",
    "ShardedPoisson",
    "ShardedSpaceTime",
    "close_world",
    "init_world",
    "make_device_mesh",
    "morton_order",
    "partition_elements",
]
