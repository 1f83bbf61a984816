// ANCF3243 instantiations of the persistent Newton-PCG kernel (resident.cuh),
// with SVK and with Mooney-Rivlin: the same family as fem_ancf3243.cu (S = 8,
// translation slots 0 and 4, which alone are centred, as pallas_fem._center
// does; Q = 12; NG = 4 groups of 3 quadrature points). A beam of at most
// 1,024 elements is one element block of the JAX banded kernels, which is
// what pallas_resident.eligible asks; the grid is then at most 32 tiles.

#include "resident.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
TLFEA_RESIDENT_ENTRY_POINTS(ancf3243, Ancf3243, tlfea::SvkMat, f32, float)
TLFEA_RESIDENT_ENTRY_POINTS(ancf3243, Ancf3243, tlfea::SvkMat, f64, double)
TLFEA_RESIDENT_ENTRY_POINTS(ancf3243_mr, Ancf3243, tlfea::MrMat, f32, float)
TLFEA_RESIDENT_ENTRY_POINTS(ancf3243_mr, Ancf3243, tlfea::MrMat, f64, double)
