// FEAT10 x Mooney-Rivlin instantiation of the element kernels K1 primal_prep,
// K2 hv, K5 contrib and K5t contrib_tangent (templates in fem_kernels.cuh,
// material algebra in mr.cuh): `pallas_fem._MRTile` (:282-463) inside
// `_primal_prep_body` (:888), `_hv_body` (:956) and `_body` (:519, its
// tangent :830), as `tile_material` (:466-480) hands it to them. No K3: the
// JAX package builds the Pallas blocks kernel for SVK only (:1374-1383), and
// the preconditioner's Mooney-Rivlin blocks are plain PyTorch here as they
// are XLA there. K4 (node_reduce) is material-free, in fem_kernels.cu.
//
// The same family parameters as fem_kernels.cu: S = 10, Q = 5, all slots
// translation slots, NG = 5 (one thread per element and quadrature point),
// partial sums in shared memory. K1 and K5 load a quadrature point's shape
// gradients (fem_kernels.cuh `Hold`), and whether K2 streams a point's
// operands through shared memory (`hv_tile`'s STREAM), as timed fastest on
// an H100 (PERF.md, Findings): in float32 K1 and K5 hold them in
// registers, K1's first point before the gather, and K2 streams (128
// registers: 3 blocks an SM, so the 10k flagship's 331 tiles run in one
// wave); in float64 all three load where used.
//
// K5t `contrib_tangent` streams a point's operands in float32 as K2 does
// (fem_kernels.cuh `contrib_tangent_stream_tile`): 233 -> 128 registers, 1
// -> 3 blocks an SM, the 10k flagship's 331 tiles in one wave instead of
// three; on an H100 (NVIDIA H100 80GB HBM3, 700 W; `python -m
// tlfea_torch.tools.kernel_variants tangent`, parent -> stream in one call)
// 16.71 -> 11.00 us at 10,584 elements, 6.84 -> 6.62 at 864 and 6.72 ->
// 6.47 at 96, bit for bit the parent. In float64 it loads where used:
// streamed it holds one block an SM (116 KB of shared memory), is no faster
// (24.20 -> 24.57 us at 10,584) and differs from the parent in last bits
// (PERF.md, Findings).

#include "fem_kernels.cuh"

using Feat10 = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
TLFEA_MR_ENTRY_POINTS(feat10, Feat10, f32, float, early, late, true,
                      tlfea::Groups, true, tlfea::Groups)
TLFEA_MR_ENTRY_POINTS(feat10, Feat10, f64, double, none, none, false,
                      tlfea::Groups, false, tlfea::Groups)
