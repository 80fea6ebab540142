// glz decode on the card: two entry points for TPU kernel #3.
//
// Both replace the Pallas kernel `_glz_resolve_kernel` / `glz_decode_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:434 and :462,
// pl.pallas_call at :494). That kernel loads one chunk of the byte plan
// (`glz.byte_plan_device`: `base` = literal bytes in place, `midx` = each
// byte's source, literal and pad bytes pointing at themselves) into VMEM,
// squares the chunk-local index three times (idx = idx[idx]) and gathers
// `base` once. Three squarings apply midx 2^3 = 8 times, and a glz stream's
// match chains are at most MAX_DEPTH = 6 long, so every byte lands on its
// literal root.
//
// 1. `fluvio_glz_resolve` keeps the Pallas kernel's (base, midx) contract;
//    its plain torch version is `kernels.glz_resolve`. One thread per
//    output byte follows its own chain for the same 8 steps, in global
//    indices, and reads `base` once; it stops early at a fixpoint (a
//    literal byte). Each step's source is clipped into the byte's chunk, as
//    the plain version clips the chunk-local index. A step onto a pad byte
//    of the ragged last chunk (index >= n) stops there and yields 0, as the
//    plain version's self-referencing zero pad does. Bound: 6 bytes a byte.
//
// 2. `fluvio_glz_decode` decodes the token arrays straight to bytes, with
//    no byte plan: the up link's path. Its plain version is the plan plus
//    the resolve (`glz.decode_plain`). Inputs: lit_lens u8[ns],
//    match_lens u8[ns], srcs i32[ns] (absolute sources), lits u8[nl], the
//    decoded size out_len, the link chunk and the stream's depth. Bound:
//    the tokens read once plus out_len written, (6 ns + nl + out_len) bytes.
//
//    a. Offsets. Exclusive prefix sums over the sequences of (lit_len +
//       match_len) (the destination) and of lit_len (the literal offset),
//       in int32 as the plan's cumsums: per-tile sums, one block scanning
//       the tile sums, then each tile rescans its own sequences.
//    b. Literal pass (fused with the rescan). Each thread takes one
//       sequence, neighbouring lanes neighbouring sequences, copies its
//       literal bytes lits[clip(lit_off + w, 0, nl - 1)] to out[dst + w] and
//       stores dst + lit_len, the start of its match bytes.
//    c. `depth` match rounds, one launch each. Each thread takes one
//       sequence and sets every match byte i = mdst + j to out[q], q =
//       srcs + j clipped into [0, out_len - 1] and then into i's chunk —
//       the plan's and the resolve's clips, in their order. A byte whose q
//       is itself reads 0, as the resolve's fixpoint on a zero base byte.
//    In both passes a warp copies its 32 sequences' bytes 32 consecutive
//    bytes a step: a byte copy a lane made on its own would cost a memory
//    transaction of its own (the first design, a thread per sequence, was
//    bound by those transactions), and a 248-byte constant run would keep
//    the rest of its warp waiting. Short runs are walked as one flat list
//    (a lane finds the run of its byte by a binary search over the warp's
//    run offsets); in the match rounds, runs of kLong bytes or more are
//    copied one at a time by the whole warp, with no search.
//
//    Why the rounds are exact. Give a literal byte depth 0 and a match byte
//    one more than its source's. A byte's final value is its root literal.
//    After round r every byte of depth <= r holds its final value, by
//    induction: a byte of depth d <= r reads its source, of depth d - 1,
//    which has been final since round r - 1 and stays so, because a final
//    byte is only ever rewritten with its final value. A byte read in the
//    middle of a round, while another thread may be writing it, is thus
//    either already final (every write of it stores the same byte) or of a
//    depth above the reader's round, so the reader is written again in a
//    later round. The rounds run in place in `out`; single-byte stores never
//    disturb their neighbours. After `depth` rounds every byte is final.
//
//    What the kernel assumes, as every `compress_link` stream guarantees:
//    the sequences cover exactly out_len bytes; sequences of length 0 (the
//    executor's zero padding) come only after the last real one; every
//    match chain is acyclic and at most `depth` long after the clips (the
//    compressor caps it at MAX_DEPTH, keeps each source inside its own
//    chunk and before the match, so the clips never fire). On such streams
//    the result equals `byte_plan_device` + `kernels.glz_resolve` byte for
//    byte. It never reads or writes out of its arrays on any stream.
//
//    Cost on the card: the copies are byte-wide and neighbouring lanes
//    touch neighbouring sequences (~14 bytes apart), so a warp's store
//    lands in a few sectors; the rounds re-read the token arrays `depth`
//    times (mostly from L2) and sources fall near their bytes. 3 + depth
//    launches a call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 8;  // 2^GLZ_SQUARE_ROUNDS applications of midx

__global__ void glz_resolve_kernel(const uint8_t* __restrict__ base,
                                   const int32_t* __restrict__ midx, long long n,
                                   long long chunk, uint8_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long lo = (i / chunk) * chunk;
    const long long hi = lo + chunk - 1;
    long long p = i;
    for (int s = 0; s < kSteps && p < n; ++s) {
      long long q = (long long)__ldg(midx + p);
      q = q < lo ? lo : (q > hi ? hi : q);
      if (q == p) break;
      p = q;
    }
    out[i] = p < n ? __ldg(base + p) : 0;
  }
}

// ---- fused decode ----------------------------------------------------------

constexpr int kThreads = 256;            // threads a scan block
constexpr int kSeqsPerThread = 8;
constexpr int kTile = kThreads * kSeqsPerThread;  // sequences a tile

// Exclusive block-wide scan of (x, y) over kThreads threads; `total` gets
// the block's sums. `warp_sums` is kThreads / 32 entries of shared memory.
__device__ inline int2 block_exclusive_scan(int2 v, int2* warp_sums, int2& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc.x, d);
    const int y = __shfl_up_sync(0xffffffffu, inc.y, d);
    if (lane >= d) {
      inc.x += x;
      inc.y += y;
    }
  }
  __syncthreads();  // warp_sums may still be read by the previous call
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int2 before = make_int2(0, 0);
  total = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      before.x += s.x;
      before.y += s.y;
    }
    total.x += s.x;
    total.y += s.y;
  }
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// (lit_len + match_len, lit_len) of sequence k (0 past the end)
__device__ inline int2 seq_lens(const uint8_t* ll, const uint8_t* ml, long long k,
                                long long ns) {
  if (k >= ns) return make_int2(0, 0);
  const int l = ll[k];
  return make_int2(l + ml[k], l);
}

// a: per-tile sums of (total, lit_len)
__global__ void glz_tile_sums_kernel(const uint8_t* __restrict__ ll,
                                     const uint8_t* __restrict__ ml, long long ns,
                                     int2* __restrict__ tile_sums) {
  __shared__ int2 warp_sums[kThreads / 32];
  const long long t0 = (long long)blockIdx.x * kTile;
  int2 v = make_int2(0, 0);
  for (int i = 0; i < kSeqsPerThread; ++i) {
    const int2 s = seq_lens(ll, ml, t0 + i * kThreads + threadIdx.x, ns);
    v.x += s.x;
    v.y += s.y;
  }
  int2 total;
  block_exclusive_scan(v, warp_sums, total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// a: one block turns the tile sums into exclusive tile offsets, in place
__global__ void glz_tile_scan_kernel(int2* __restrict__ tile_sums, long long n_tiles) {
  __shared__ int2 warp_sums[kThreads / 32];
  int2 carry = make_int2(0, 0);
  for (long long b = 0; b < n_tiles; b += kThreads) {
    const long long k = b + threadIdx.x;
    const int2 v = k < n_tiles ? tile_sums[k] : make_int2(0, 0);
    int2 total;
    const int2 ex = block_exclusive_scan(v, warp_sums, total);
    if (k < n_tiles) tile_sums[k] = make_int2(carry.x + ex.x, carry.y + ex.y);
    carry.x += total.x;
    carry.y += total.y;
  }
}

constexpr int kBatch = 4;  // bytes a lane loads before it stores them

// The warp's bytes as one flat list: lane l's run (n_l bytes) occupies
// positions [excl_l, excl_l + n_l) of it. `flat_owner` finds the lane
// owning position t (the last lane with excl <= t: lanes with an empty run
// share their excl with the next lane, so they are never picked) by a
// binary search over the warp's excl values; every lane takes part.
struct FlatList {
  int excl, total;
  __device__ inline explicit FlatList(int n) {
    const int lane = threadIdx.x & 31;
    int inc = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += t;
    }
    excl = inc - n;
    total = __shfl_sync(0xffffffffu, inc, 31);
  }
  // (owner lane, position within the owner's run) of flat position t
  __device__ inline int2 owner(int t) const {
    int l = 0, e = 0;
#pragma unroll
    for (int b = 16; b >= 1; b >>= 1) {
      const int ec = __shfl_sync(0xffffffffu, excl, l + b);
      if (ec <= t) {
        l += b;
        e = ec;
      }
    }
    return make_int2(l, t - e);
  }
};

// a + b: rescan the tile's sequences, copy literal bytes, store match starts
__global__ void glz_literal_kernel(const uint8_t* __restrict__ ll,
                                   const uint8_t* __restrict__ ml,
                                   const uint8_t* __restrict__ lits, long long nl, long long ns,
                                   const int2* __restrict__ tile_off, int out_len,
                                   int32_t* __restrict__ mdst, uint8_t* __restrict__ out) {
  __shared__ int2 warp_sums[kThreads / 32];
  const long long t0 = (long long)blockIdx.x * kTile;
  int2 carry = tile_off[blockIdx.x];
  for (int i = 0; i < kSeqsPerThread; ++i) {
    const long long k = t0 + i * kThreads + threadIdx.x;
    const int2 v = seq_lens(ll, ml, k, ns);  // (0, 0) past the end
    int2 total;
    const int2 ex = block_exclusive_scan(v, warp_sums, total);
    const int dst = carry.x + ex.x;
    const long long lit0 = (long long)carry.y + ex.y;
    carry.x += total.x;
    carry.y += total.y;
    if (k < ns) mdst[k] = dst + v.y;
    // the warp's literal bytes as one run of lits: flat position t reads
    // lits[first lit0 + t], and lands at its owner's dst + offset
    const FlatList flat(v.y);
    const long long lit_base = __shfl_sync(0xffffffffu, lit0, 0);
    for (int base = 0; base < flat.total; base += 32) {
      const int t = base + (threadIdx.x & 31);
      const int2 o = flat.owner(t);
      const long long p = (long long)__shfl_sync(0xffffffffu, dst, o.x) + o.y;
      if (t < flat.total && p >= 0 && p < out_len) {
        long long s = lit_base + t;
        s = s < 0 ? 0 : (s > nl - 1 ? nl - 1 : s);
        out[p] = nl > 0 ? __ldg(lits + s) : 0;
      }
    }
  }
}

// Byte i of a match run reads out[q], q = the run's src + j clipped into
// [0, out_len - 1] and then into i's chunk (lo0: the chunk start of the
// run's first byte; a run of <= 255 bytes crosses few chunk starts).
// Returns the byte, or -1 where i lies outside out.
__device__ inline int match_byte(long long i, long long q, int lo0, int out_len, int chunk,
                                 const uint8_t* out) {
  if (i < 0 || i >= out_len) return -1;
  long long lo = lo0;
  while (i - lo >= chunk) lo += chunk;
  q = q < 0 ? 0 : (q > out_len - 1 ? out_len - 1 : q);
  q = q < lo ? lo : (q > lo + chunk - 1 ? lo + chunk - 1 : q);
  return q == i ? 0 : out[q];
}

// c: one match round. Runs of kLong bytes or more are copied by the whole
// warp, one run at a time, 32 bytes a step; the warp's shorter runs form
// one flat list that the lanes walk together. Either way neighbouring lanes
// write (and mostly read) neighbouring bytes, and each lane loads kBatch
// bytes before it stores them.
constexpr int kLong = 32;

__global__ void glz_match_round_kernel(const uint8_t* __restrict__ ml,
                                       const int32_t* __restrict__ srcs,
                                       const int32_t* __restrict__ mdst, long long ns,
                                       int out_len, int chunk, uint8_t* out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every lane stays to the end: the warp shares the copying
  const int m = k < ns ? ml[k] : 0;
  const int i0 = m > 0 ? mdst[k] : 0;
  const int src = m > 0 ? srcs[k] : 0;
  const int lo0 = i0 > 0 ? i0 / chunk * chunk : 0;
  const FlatList flat(m < kLong ? m : 0);
  for (int base = 0; base < flat.total; base += 32 * kBatch) {
    int at[kBatch], v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = base + u * 32 + lane;
      const int2 o = flat.owner(t);
      const long long i = (long long)__shfl_sync(0xffffffffu, i0, o.x) + o.y;
      const long long q = (long long)__shfl_sync(0xffffffffu, src, o.x) + o.y;
      const int lo = __shfl_sync(0xffffffffu, lo0, o.x);
      at[u] = (int)i;
      v[u] = t < flat.total ? match_byte(i, q, lo, out_len, chunk, out) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (v[u] >= 0) out[at[u]] = (uint8_t)v[u];
    }
  }
  unsigned longs = __ballot_sync(0xffffffffu, m >= kLong);
  while (longs) {
    const int l = __ffs(longs) - 1;
    longs &= longs - 1;
    const int li0 = __shfl_sync(0xffffffffu, i0, l);
    const int lsrc = __shfl_sync(0xffffffffu, src, l);
    const int llo0 = __shfl_sync(0xffffffffu, lo0, l);
    const int lm = __shfl_sync(0xffffffffu, m, l);
    for (int j0 = 0; j0 < lm; j0 += 32 * kBatch) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * 32 + lane;
        v[u] = j < lm ? match_byte((long long)li0 + j, (long long)lsrc + j, llo0, out_len,
                                   chunk, out)
                      : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (v[u] >= 0) out[li0 + j0 + u * 32 + lane] = (uint8_t)v[u];
      }
    }
  }
}

}  // namespace

extern "C" int fluvio_glz_resolve(const void* base, const void* midx, long long n,
                                  long long chunk, void* out, void* stream) {
  if (n > 0 && chunk > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    glz_resolve_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(base), static_cast<const int32_t*>(midx), n, chunk,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}

// Token arrays -> out u8[out_len]. Scratch from the caller: tile_sums
// int32[2 * ceil(ns / 2048)] and mdst int32[ns].
extern "C" int fluvio_glz_decode(const void* lit_lens, const void* match_lens, const void* srcs,
                                 const void* lits, long long ns, long long nl, int out_len,
                                 int chunk, int depth, void* tile_sums, void* mdst, void* out,
                                 void* stream) {
  if (chunk <= 0 || out_len < 0 || depth < 0) return (int)cudaErrorInvalidValue;
  if (ns > 0 && out_len > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* ll = static_cast<const uint8_t*>(lit_lens);
    const auto* ml = static_cast<const uint8_t*>(match_lens);
    auto* tiles = static_cast<int2*>(tile_sums);
    auto* md = static_cast<int32_t*>(mdst);
    auto* o = static_cast<uint8_t*>(out);
    const long long n_tiles = (ns + kTile - 1) / kTile;
    glz_tile_sums_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(ll, ml, ns, tiles);
    glz_tile_scan_kernel<<<1, kThreads, 0, st>>>(tiles, n_tiles);
    glz_literal_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
        ll, ml, static_cast<const uint8_t*>(lits), nl, ns, tiles, out_len, md, o);
    const unsigned blocks = (unsigned)((ns + kThreads - 1) / kThreads);
    for (int r = 0; r < depth; ++r) {
      glz_match_round_kernel<<<blocks, kThreads, 0, st>>>(
          ml, static_cast<const int32_t*>(srcs), md, ns, out_len, chunk, o);
    }
  }
  return (int)cudaGetLastError();
}
