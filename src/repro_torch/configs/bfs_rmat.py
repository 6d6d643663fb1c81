"""bfs-rmat: the paper's own architecture -- degree-separated distributed
(DO)BFS on Graph500 RMAT graphs (TH=64-256, factors (.5,.05,1e-7)).

The port's copies of ``repro.configs.bfs_rmat`` ``FULL`` / ``SMOKE`` /
``OPT`` / ``OPT2`` as :class:`repro_torch.core.bfs.BFSConfig`, registered
under the same names with ``BFS_SHAPES``.
"""
from repro_torch.configs.base import ArchSpec, BFS_SHAPES, register
from repro_torch.core.bfs import BFSConfig

FULL = BFSConfig(max_iters=64, enable_do=True, uniquify=False, pull_chunk=64)
SMOKE = BFSConfig(max_iters=32, enable_do=True)

CONFIG = register(ArchSpec(
    name="bfs-rmat", family="bfs", model=FULL, smoke=SMOKE, shapes=BFS_SHAPES,
    notes="paper-faithful flagship; weak-scaling shape pins ~scale-26 RMAT "
          "per device like the paper's Fig. 9",
))

# Beyond-paper optimized variant: expectation-sized a2a bins (4 E_nn/p per
# peer vs E_nn) and 1-byte delegate OR-reduction (the paper's bitmask
# volume class, vs int32 levels).
OPT = BFSConfig(max_iters=64, enable_do=True, uniquify=False, pull_chunk=64,
                cap_nn=-4, delegate_u8=True)

CONFIG_OPT = register(ArchSpec(
    name="bfs-rmat-opt", family="bfs", model=OPT, smoke=OPT, shapes=BFS_SHAPES,
    notes="optimized comm variant of bfs-rmat (SPerf hillclimb)",
))

# Static-slot 1-bit nn exchange on the precomputed plan (uniquification for
# free, no runtime sort, cap_total/8 bytes per step).
OPT2 = BFSConfig(max_iters=64, enable_do=True, pull_chunk=64,
                 delegate_u8=True, static_exchange=True)

CONFIG_OPT2 = register(ArchSpec(
    name="bfs-rmat-opt2", family="bfs", model=OPT2, smoke=OPT2,
    shapes=BFS_SHAPES,
    notes="static-slot bitmask nn exchange variant (SPerf hillclimb iter 3)",
))

__all__ = ["BFS_SHAPES", "CONFIG", "CONFIG_OPT", "CONFIG_OPT2", "FULL", "OPT",
           "OPT2", "SMOKE"]
