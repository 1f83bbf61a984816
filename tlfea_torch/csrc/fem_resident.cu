// FEAT10 instantiations of the persistent Newton-PCG kernel (resident.cuh),
// with SVK and with Mooney-Rivlin: the same family as fem_kernels.cu and
// fem_feat10_mr.cu (S = 10, Q = 5, all slots translation slots, NG = 5,
// partial sums in shared memory).

#include "resident.cuh"

using Feat10 = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
TLFEA_RESIDENT_ENTRY_POINTS(feat10, Feat10, tlfea::SvkMat, f32, float)
TLFEA_RESIDENT_ENTRY_POINTS(feat10, Feat10, tlfea::SvkMat, f64, double)
TLFEA_RESIDENT_ENTRY_POINTS(feat10_mr, Feat10, tlfea::MrMat, f32, float)
TLFEA_RESIDENT_ENTRY_POINTS(feat10_mr, Feat10, tlfea::MrMat, f64, double)
