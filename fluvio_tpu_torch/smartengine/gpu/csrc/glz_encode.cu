// glz encode window match: the literal root of every 8-byte group.
//
// Replaces the Pallas kernel `_glz_enc_match_kernel` / `glz_encode_match`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:541 and :576,
// pl.pallas_call at :605). That kernel loads one chunk of group words (w0,
// w1) and a not-constant flag into VMEM; each group's candidate is the
// group at the smallest of 39 static distances (GLZ_ENC_DISTANCES, :521)
// with equal words, both groups outside constant runs; then
// ceil(log2(chunk_groups)) squarings cand = cand[cand] carry every chain to
// its root, an equal-valued literal. The plain torch version is
// `kernels.glz_encode_match`.
//
// On the card, two steps in global indices:
//   (a) one thread per group probes the distances from the smallest up and
//       takes the first hit (the Pallas kernel writes largest first, so its
//       last write, the smallest distance, wins: the same group). A probe
//       needs d < chunk_groups and d <= the group's index in its chunk, so
//       candidates never leave the chunk; pad groups past G are never
//       probed.
//   (b) exactly `rounds` pointer jumps, one launch each, between two
//       buffers. A chain within a chunk is at most chunk_groups - 1 long, so
//       `rounds` jumps (2^rounds >= chunk_groups) reach the root, and every
//       chunk size runs (no shared-memory ceiling). Chasing each chain
//       serially instead would cost a period-2 corpus ~chunk_groups / 2
//       dependent loads a group.
//
// Bound on the card: bytes, 13 a group (w0, w1, the flag, the root). At the
// main path's sizes (a few hundred thousand groups) that is microseconds,
// so the 1 + rounds launches set the time, not the bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNumDistances = 39;
__constant__ int kDistances[kNumDistances] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 40, 48, 56, 64, 80, 96, 128};

__global__ void enc_candidates(const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
                               const uint8_t* __restrict__ const_m, int g_count,
                               int chunk_groups, int32_t* __restrict__ cand) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < g_count;
       g += gridDim.x * blockDim.x) {
    int root = g;
    if (!const_m[g]) {
      const int local = g % chunk_groups;
      const int a = w0[g], b = w1[g];
      for (int k = 0; k < kNumDistances; ++k) {
        const int d = kDistances[k];
        if (d >= chunk_groups || d > local) break;  // ascending: no later d fits
        const int s = g - d;
        if (!const_m[s] && w0[s] == a && w1[s] == b) {
          root = s;
          break;
        }
      }
    }
    cand[g] = root;
  }
}

__global__ void enc_jump(const int32_t* __restrict__ src, int g_count,
                         int32_t* __restrict__ dst) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < g_count;
       g += gridDim.x * blockDim.x) {
    dst[g] = src[src[g]];
  }
}

}  // namespace

extern "C" int fluvio_glz_enc_match(const void* w0, const void* w1, const void* const_m,
                                    int g_count, int chunk_groups, int rounds, void* scratch,
                                    void* out, void* stream) {
  if (g_count <= 0 || chunk_groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long blocks = ((long long)g_count + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  // the result must land in `out` after `rounds` swaps
  int32_t* bufs[2] = {static_cast<int32_t*>(out), static_cast<int32_t*>(scratch)};
  int cur = rounds & 1;
  enc_candidates<<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1),
      static_cast<const uint8_t*>(const_m), g_count, chunk_groups, bufs[cur]);
  cudaError_t err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    enc_jump<<<(unsigned)blocks, threads, 0, s>>>(bufs[cur], g_count, bufs[cur ^ 1]);
    cur ^= 1;
    err = cudaGetLastError();
  }
  return (int)err;
}
