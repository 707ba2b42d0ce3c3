// K7b fanout_attention_bwd's warp path with the mode fixed, fp32 tables:
// the forms of GIGL_K7B_FAST (fanout_attention_bwd_warp.cuh), built beside
// fanout_attention_bwd.cu so that the two compile in parallel.
#include "fanout_attention_bwd_warp.cuh"

namespace gigl {
namespace k7b {
GIGL_K7B_FAST(GIGL_K7B_DEFINE, float)
}  // namespace k7b
}  // namespace gigl
