// The radix pass kernel's instances with 8-byte planes
// (rank_scatter_wide_kernel, radix_pass.cuh), compiled beside radix.cu so
// that neither unit waits on the other's 45 instances.  radix.cu's
// dispatcher calls rank_scatter_wide for a launch whose `wide` mask is set.

#include "radix_pass.cuh"

namespace rst {

bool rank_scatter_wide(const PassArgs& a, bool lookback, bool word64,
                       int key_bytes, int tile, int threads,
                       cudaStream_t stream) {
  if (!lookback)
    return rank_scatter_keyed<false, unsigned, true>(key_bytes, tile, threads,
                                                     a, stream);
  return word64 ? rank_scatter_keyed<true, unsigned long long, true>(
                      key_bytes, tile, threads, a, stream)
                : rank_scatter_keyed<true, unsigned, true>(
                      key_bytes, tile, threads, a, stream);
}

}  // namespace rst
