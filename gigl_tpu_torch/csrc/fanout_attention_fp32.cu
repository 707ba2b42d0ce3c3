// K7 fanout_attention's warp path with the mode fixed, fp32 tables: the
// forms of GIGL_K7_FAST (fanout_attention_warp.cuh), built beside
// fanout_attention.cu so that the two compile in parallel.
#include "fanout_attention_warp.cuh"

namespace gigl {
namespace k7 {
GIGL_K7_FAST(GIGL_K7_DEFINE, float)
}  // namespace k7
}  // namespace gigl
