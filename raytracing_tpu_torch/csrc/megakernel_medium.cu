// K1's MEDIUM instantiations (participating media), in a translation unit
// of their own: the build compiles each csrc/*.cu with its own nvcc, at
// once, so they build beside megakernel_block.cu instead of after its
// other instantiations. The kernel, its device functions and its launch
// are megakernel_block.cu's; this unit defines only
// rt_k1_launch_medium, which rt_trace_block calls for a scene with media.
#define RT_K1_MEDIUM_UNIT
#include "megakernel_block.cu"
