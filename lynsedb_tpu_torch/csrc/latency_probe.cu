// A pointer chase: one thread follows next[] for `hops` loads, each address
// taken from the load before, so the launch's time over hops is the latency
// of one dependent global load (from device memory where the chain spans far
// more than the 50 MB L2 cache). Not a port of a TPU kernel: it measures the
// latency that bounds K17's walk (tools/roofline.py walk_bound; chip_smoke.py,
// tools/tile_times.py), two such loads a step.
#include "common.cuh"

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start, int hops,
                             int* __restrict__ out) {
  int p = start;
  for (int h = 0; h < hops; ++h) p = __ldcg(next + p);
  *out = p;
}

}  // namespace

// next (n,) int32 a permutation's successor table; out (1,) int32 the last
// index reached (so the chain is not optimised away).
extern "C" int lt_pointer_chase(const int* next, int start, int hops, int* out,
                                cudaStream_t stream) {
  if (next == nullptr || out == nullptr || start < 0 || hops < 1)
    return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, stream>>>(next, start, hops, out);
  return (int)cudaGetLastError();
}
