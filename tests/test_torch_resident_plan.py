"""The persistent kernel's launch plan (`tlfea_torch.ops.resident.plan`), on
the CPU: for every (family, material) pair with a kernel, in float32 and
float64, at the gate's edge cases of E, each tile goes to exactly one block
of one cluster of at most 16 blocks, the virtual grid is one block per tile
(the bits of the cooperative grid it replaced), and a block's shared memory
fits the H100's 232,448 bytes. The plan reads the family, the material, E
and the dtype, and no mesh. The card tests hold the kernel's own count of
shared memory to the plan's (`tests/test_torch_cuda.py`).
"""

import inspect

import pytest
import torch

from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import resident

SMEM_PER_BLOCK = 232_448  # an H100 block's largest dynamic shared memory
SIZES = (1, 31, 32, 33, 64, 864, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("pair", sorted(fk.RESIDENT_SOURCES), ids=lambda p: "_".join(p))
def test_plan_covers_every_tile_once_within_one_cluster(pair, dtype):
    family, kind = pair
    for max_cluster in (16, 8):
        for E in SIZES:
            pl = resident.plan(family, kind, E, dtype, max_cluster)
            n_tiles = -(-E // 32)
            assert pl.n_tiles == n_tiles
            assert 1 <= pl.cluster <= min(16, max_cluster)
            assert pl.cluster & (pl.cluster - 1) == 0  # a power of two
            assert len(pl.tiles) == pl.cluster
            owned = sorted(t for block in pl.tiles for t in block)
            assert owned == list(range(n_tiles)), (E, max_cluster)
            assert all(len(block) <= pl.rounds for block in pl.tiles)
            assert pl.rounds == max(len(block) for block in pl.tiles)
            assert pl.smem_bytes == sum(b for _, b in pl.shared)
            assert pl.smem_bytes <= SMEM_PER_BLOCK, (E, pl.smem_bytes)
            assert pl.threads <= 1024


def test_plan_at_the_gate_sizes():
    """The 1k box (864 elements, 27 tiles) runs on 16 blocks of two slabs,
    two virtual blocks each at most; 64 elements on 2 blocks; float64 FEAT10
    MR at 1,024 elements stages two K1 tiles of 61,440 bytes a block."""
    pl = resident.plan("feat10", "svk", 864, torch.float32)
    assert (pl.cluster, pl.n_tiles, pl.rounds, pl.slabs) == (16, 27, 2, 2)
    assert pl.tiles[0] == (0, 16) and pl.tiles[15] == (15,)
    assert resident.plan("ancf3243", "mr", 64, torch.float32).cluster == 2
    big = resident.plan("feat10", "mr", 1024, torch.float64)
    assert dict(big.shared)["tile staging"] == 2 * 61_440
    assert resident.plan("feat10", "svk", 1024, torch.float64, 8).rounds == 4


def test_plan_needs_no_mesh_and_refuses_what_the_gate_refuses():
    params = list(inspect.signature(resident.plan).parameters)
    assert params == ["family", "kind", "E", "dtype", "max_cluster"]
    with pytest.raises(ValueError, match="no newton_resident kernel"):
        resident.plan("ancf3443", "svk", 64, torch.float32)
    for E in (0, resident.MAX_ELEMS + 1):
        with pytest.raises(ValueError, match="elements"):
            resident.plan("feat10", "svk", E, torch.float32)
