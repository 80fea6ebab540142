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
// Bound on the card: bytes, 13 a group (w0, w1, the flag, the root): a
// microsecond at the main path's few hundred thousand groups. A port of the
// squaring loop into global memory pays ceil(log2(chunk_groups)) dependent
// launches (16 at 256 KiB chunks), and those, not the bytes, set its time.
// This design runs two launches for every chunk size, using what the VMEM
// loop could not: every candidate edge points back by at most 128 groups
// (the largest distance), so a chain that leaves a tile never comes back
// to it. Both launches are latency-bound (a block's loads, its probe loop
// and its barriers), so a block is 1,024 threads and issues all its loads
// before its first store.
//
// 1. `enc_tile` (a block a tile of kTile groups; tiles never straddle a
//    chunk, so the work spreads over tiles, not chunks). The block stages
//    its tile and the 128 groups before it (the halo, none for a chunk's
//    first tile) in shared memory with coalesced loads: a group's two words
//    as one 8-byte word, and the constant-run flags. Each group probes the
//    distances from the smallest up and takes the first hit (the Pallas
//    kernel writes largest first, so its last write, the smallest distance,
//    wins: the same group); a probe is one shared load, and the target's
//    flag is read only on equal words. A probe needs d < chunk_groups and
//    d <= the group's index in its chunk, so candidates never leave the
//    chunk, and every candidate of a tile group lies in the tile or its
//    halo. Pad groups past G are never probed. Halo groups are fixed
//    points. ceil(log2(kTile)) synchronous pointer jumps in shared memory
//    (two buffers in the words' place) carry each tile group to the end of
//    its chain inside the tile, or to the first halo group on it (the
//    exit): a chain steps strictly back, so it visits at most kTile tile
//    groups. The block writes a root as its global index and an exit h as
//    -(h + 1).
// 2. `enc_join` (the same grid; a chunk's first tile has no exits). The
//    exits of tile t name groups of tile t - 1's last 128 (its tail).
//    Lane k of the block finds the final root of tail group k of tile t - 1
//    by chasing exits back: through the tails of the previous kWindow
//    tiles, staged in shared memory with coalesced loads, then, for a
//    chain that runs further, through global memory. Each exit of the tile
//    then takes the root of its tail group. Blocks write their own tile
//    only and read earlier tiles, which their own blocks may be rewriting
//    at the same time: a reader sees either an exit or the root it
//    resolves to, and both lead to the same root.
//
// The tile size is the H100's best of 1,024, 2,048 and 4,096 groups at the
// main path's descriptor stream (PERF.md): smaller tiles give more blocks
// and shorter barriers, at more tails for the join to chase.
//
// Exactness: a chain inside a chunk holds at most chunk_groups groups, so
// the Pallas kernel's squarings end every chain at its root; this design
// follows the same candidate edges (the same probes on the same staged
// values) to the same end, a tile at a time: in tile 0 of a chunk chains
// end at their roots; in tile t a chain either ends in the tile or passes
// its first halo group h, a tail group of tile t - 1, whose root is its own
// chain's end, resolved by the same rule. tests/test_torch_encode_extract_redesign.py
// models both launches in numpy and holds them to the plain version and the
// Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNumDistances = 39;
__constant__ int kDistances[kNumDistances] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 40, 48, 56, 64, 80, 96, 128};

constexpr int kHalo = 128;     // the largest distance
constexpr int kTile = 1024;    // groups a tile (fewer where the chunk is smaller)
constexpr int kThreads = 1024;
constexpr int kPerThread = kTile / kThreads;
constexpr int kLoads = (kHalo + kTile + kThreads - 1) / kThreads;  // staged groups a thread
constexpr int kWindow = 32;    // tails of earlier tiles the join stages
constexpr int kTailLoads = kWindow * kHalo / kThreads;

__global__ void __launch_bounds__(kThreads)
enc_tile(const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
         const uint8_t* __restrict__ const_m, int g_count, int chunk_groups, int tile,
         int tiles_per_chunk, int rounds, int32_t* __restrict__ out) {
  // a group's two words as one (w1 << 32 | w0), then two pointer buffers
  __shared__ unsigned long long sw[kHalo + kTile];
  __shared__ uint8_t sc[kHalo + kTile];
  const int c = blockIdx.x / tiles_per_chunk, t = blockIdx.x - c * tiles_per_chunk;
  const int t0 = t * tile;                             // in the chunk
  const long long base = (long long)c * chunk_groups + t0;  // global
  if (base >= g_count) return;
  const int hl = t > 0 ? kHalo : 0;
  int tl = chunk_groups - t0 < tile ? chunk_groups - t0 : tile;
  if (base + tl > g_count) tl = (int)(g_count - base);
  const long long from = base - hl;
  // every load in flight before the first store
  uint32_t la[kLoads], lb[kLoads];
  uint8_t lc[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int p = threadIdx.x + r * kThreads;
    if (p < hl + tl) {
      la[r] = (uint32_t)w0[from + p];
      lb[r] = (uint32_t)w1[from + p];
      lc[r] = const_m[from + p];
    }
  }
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int p = threadIdx.x + r * kThreads;
    if (p < hl + tl) {
      sw[p] = (unsigned long long)lb[r] << 32 | la[r];
      sc[p] = lc[r];
    }
  }
  __syncthreads();

  int cand[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int p = hl + i;
    int root = p;
    if (i < tl && !sc[p]) {
      // d < chunk_groups and d <= the group's index in its chunk
      const int lim = chunk_groups - 1 < t0 + i ? chunk_groups - 1 : t0 + i;
      const unsigned long long me = sw[p];
#pragma unroll
      for (int k = 0; k < kNumDistances; ++k) {
        const int d = kDistances[k];
        if (d > lim) break;  // ascending: no later d fits
        // words first (one shared load), the constant flag only on a match
        if (sw[p - d] == me && !sc[p - d]) {
          root = p - d;
          break;
        }
      }
    }
    cand[r] = root;
  }
  __syncthreads();  // the words are read; their array becomes two pointer buffers
  int32_t* cur = reinterpret_cast<int32_t*>(sw);
  int32_t* nxt = cur + kHalo + kTile;
  for (int p = threadIdx.x; p < hl; p += kThreads) cur[p] = nxt[p] = p;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) cur[hl + threadIdx.x + r * kThreads] = cand[r];
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < tl) nxt[hl + i] = cur[cur[hl + i]];
    }
    __syncthreads();
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < tl) {
      const int q = cur[hl + i];
      const int g = (int)(from + q);
      out[base + i] = q >= hl ? g : -(g + 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
enc_join(int g_count, int chunk_groups, int tile, int tiles_per_chunk, int32_t* out) {
  __shared__ int32_t tails[kWindow * kHalo];
  __shared__ int32_t carry[kHalo];
  const int c = blockIdx.x / tiles_per_chunk, t = blockIdx.x - c * tiles_per_chunk;
  if (t == 0) return;  // a chunk's first tile has no halo, so no exits
  const long long cbase = (long long)c * chunk_groups;
  const long long base = cbase + (long long)t * tile;
  if (base >= g_count) return;
  int tl = chunk_groups - t * tile < tile ? chunk_groups - t * tile : tile;
  if (base + tl > g_count) tl = (int)(g_count - base);
  // tails of tiles lo .. t - 1 (every one a full tile) and the tile's own
  // roots and exits, all loads in flight together
  const int lo = t > kWindow ? t - kWindow : 0;
  const int nw = t - lo;
  int32_t tv[kTailLoads], own[kPerThread];
#pragma unroll
  for (int r = 0; r < kTailLoads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e < nw * kHalo) {
      const int u = lo + e / kHalo;
      tv[r] = out[cbase + (long long)(u + 1) * tile - kHalo + (e % kHalo)];
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = threadIdx.x + r * kThreads;
    own[r] = i < tl ? out[base + i] : 0;
  }
#pragma unroll
  for (int r = 0; r < kTailLoads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e < nw * kHalo) tails[e] = tv[r];
  }
  __syncthreads();
  if (threadIdx.x < kHalo) {
    int u = t - 1, k = threadIdx.x;
    int v = tails[(u - lo) * kHalo + k];
    // an exit of tile u names a tail group of tile u - 1
    while (v < 0 && u > lo) {
      k = (int)(-(long long)v - 1 - (cbase + (long long)u * tile - kHalo));
      --u;
      v = tails[(u - lo) * kHalo + k];
    }
    while (v < 0) v = out[-(long long)v - 1];  // past the window
    carry[threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < tl && own[r] < 0) out[base + i] = carry[-(long long)own[r] - 1 - (base - kHalo)];
  }
}

}  // namespace

extern "C" int fluvio_glz_enc_match(const void* w0, const void* w1, const void* const_m,
                                    int g_count, int chunk_groups, void* out, void* stream) {
  if (g_count <= 0 || chunk_groups <= 0 || chunk_groups % kHalo) {
    return g_count <= 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = chunk_groups < kTile ? chunk_groups : kTile;
  const int tiles_per_chunk = (chunk_groups + tile - 1) / tile;
  const long long chunks = ((long long)g_count + chunk_groups - 1) / chunk_groups;
  const long long blocks = chunks * tiles_per_chunk;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int rounds = 0;
  while ((1 << rounds) < tile) ++rounds;
  auto* o = static_cast<int32_t*>(out);
  enc_tile<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1),
      static_cast<const uint8_t*>(const_m), g_count, chunk_groups, tile, tiles_per_chunk,
      rounds, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles_per_chunk == 1) return (int)err;
  enc_join<<<(unsigned)blocks, kThreads, 0, s>>>(g_count, chunk_groups, tile, tiles_per_chunk,
                                                  o);
  return (int)cudaGetLastError();
}
