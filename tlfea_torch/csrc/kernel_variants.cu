// Other instantiations of the element kernels, for timing the choice of NG
// (quadrature-point groups per element) and REG_BYTES (partial sums in
// registers) against the shipped ones (FEAT10: NG 5, shared partials;
// ANCF3443: NG 4, register partials):
// `python -m tlfea_torch.tools.kernel_variants`.
// Not part of the library that `build_kernels` builds.
#include "fem_kernels.cuh"

using F10regs = tlfea::Family<10, 5, 0x3FFu, 5, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs, F10regs, f32, float)
using F10regs1 = tlfea::Family<10, 5, 0x3FFu, 1, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs1, F10regs1, f32, float)
using S4smem = tlfea::Family<16, 48, 0x1111u, 4, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s4smem, S4smem, f32, float)
using S6regs = tlfea::Family<16, 48, 0x1111u, 6, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s6regs, S6regs, f32, float)
using S8smem = tlfea::Family<16, 48, 0x1111u, 8, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s8smem, S8smem, f32, float)
using S8regs = tlfea::Family<16, 48, 0x1111u, 8, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s8regs, S8regs, f32, float)

// Mooney-Rivlin at the ANCF shapes: the shipped instantiations keep the SVK
// families' NG and partial sums (fem_ancf3243_mr.cu, fem_ancf3443_mr.cu);
// these put the partials in shared memory, or split the shell's points
// into 8 groups.
using S4smemMr = tlfea::Family<16, 48, 0x1111u, 4, 0>;
TLFEA_MR_ENTRY_POINTS(s4smem, S4smemMr, f32, float)
using S8smemMr = tlfea::Family<16, 48, 0x1111u, 8, 0>;
TLFEA_MR_ENTRY_POINTS(s8smem, S8smemMr, f32, float)
using B4smemMr = tlfea::Family<8, 12, 0x11u, 4, 0>;
TLFEA_MR_ENTRY_POINTS(b4smem, B4smemMr, f32, float)
