// FEAT10 instantiation of the persistent Newton-PCG kernel (resident.cuh):
// the same family as fem_kernels.cu (S = 10, Q = 5, all slots translation
// slots, NG = 5, partial sums in shared memory).

#include "resident.cuh"

using Feat10 = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
TLFEA_RESIDENT_ENTRY_POINTS(feat10, Feat10, f32, float)
TLFEA_RESIDENT_ENTRY_POINTS(feat10, Feat10, f64, double)
