// JSON-array explode over the striped wide-record layout: one entry point.
//
// `fluvio_json_array_striped` replaces no Pallas kernel. The JAX package
// explodes a JSON array on the narrow layout only (`kernels.json_array_bounds`,
// an XLA column scan); a batch wider than its stripe threshold through such a
// chain spills to its interpreter (fluvio_tpu/smartengine/tpu/executor.py:1527,
// `dsl.json_array_elements`, fluvio_tpu/smartmodule/dsl.py:131). This kernel
// computes that function's element grid over the port's stripe rows, so the
// batch stays on the card. Plain torch version:
// `stripes.striped_json_array_bounds`; chip_smoke.py holds the kernel to it
// exactly.
//
// What it computes, per segment (one record's k stripe rows, in order):
// the record's bytes in record order are the bytes each row OWNS (the first
// `step` of a row that is not its record's last, every live byte of the last
// one; the overlap tail belongs to the next row). The outer first and last
// non-whitespace bytes (tab, LF, VT, FF, CR, space: `bytes.strip()`) must be
// '[' and ']', else `err`. Between them a quote opens or closes a string, a
// backslash inside a string skips the next byte (across a seam too),
// '[' '{' and ']' '}' outside strings move the depth, and a ',' at depth 0
// outside strings ends an element, as the closing ']' does. An element is
// trimmed of whitespace and of its quotes when its first and last bytes are
// both quotes; an empty one is dropped. Its flag, record-absolute start and
// length are written at the row and column that own its trimmed start, so
// the row-major flag order is record order (`kernels.fanout_scatter` places
// the elements from it); every other grid cell stays as the wrapper zeroed it.
//
// Bound on the card: bytes, each owned byte read once, the three [r, s]
// grids written once (the wrapper's zero fill writes them; the kernel writes
// only an element's cell). The string, escape and depth state is a chain of
// dependent steps through the whole record.
//
// Design: a block a segment (kThreads = 256 threads, so a batch of 1,024
// records is 1,024 blocks over all 132 SMs). The dropped first design, a
// thread a segment in 32-thread blocks, ran 1,024 records of ~71.7 KB as 32
// warps on 32 SMs, each thread a chain of ~71.6 K dependent steps over
// uncoalesced 4-byte loads: 22.251 device ms against a 0.2504 ms bound
// (PERF.md, PR 24). Here the block walks the segment's owned bytes in
// record order a tile at a time: a tile is kTile = 8,192 bytes of one row
// (a row of the default 8,192-byte stripes is one tile), kChunk = 32
// consecutive bytes a lane, loaded as two 16-byte words (neighbouring
// lanes on neighbouring addresses) where the stripe width is a multiple of
// 32 and the grid 16-byte aligned, else as 4-byte words. For each tile:
//
// 1. State maps. Each lane composes its bytes' maps over the three string
//    states (outside, inside, inside after a backslash) and the depth
//    change from each entry state. A warp shuffle scan, then one thread's
//    fold over the warps' totals from the carry, give every lane its exact
//    entry state and depth. The carry passes from tile to tile, so across
//    every stripe seam.
// 2. Boundaries. Each lane walks its 32 bytes again from its entry state,
//    marking the boundaries (a ',' at depth 0 outside strings, and the
//    record's closing ']') and the element bytes (the other non-whitespace
//    bytes), and reduces them to (boundary seen, first element byte after
//    its last boundary, last element byte).
// 3. Trimming. A second warp scan and fold of those triples, from the
//    carry of the tiles before, gives each lane the open element's first
//    and last bytes at its start; the lane replays its marks, and at each
//    boundary the element's trimmed start and length are known and
//    written. An element still open at the tile's end carries into the next.
//
// The outer first and last non-whitespace bytes, which give `err`, come
// first, from a block min (max) reduction over the tiles from the record's
// start (end), stopping at the first tile that holds one.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // bytes a lane a tile
constexpr int kTile = kThreads * kChunk;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool is_ws(uint32_t c) { return (c >= 9u && c <= 13u) || c == 32u; }

// the string state after byte b: 0 outside, 1 inside, 2 inside after a backslash
__device__ __forceinline__ int str_next(int st, uint32_t b) {
  if (b == '"') return st == 1 ? 0 : 1;
  if (b == '\\') return st == 1 ? 2 : (st == 2 ? 1 : 0);
  return st == 2 ? 1 : st;
}

__device__ __forceinline__ int depth_step(uint32_t b) {
  return (b == '[' || b == '{') ? 1 : ((b == ']' || b == '}') ? -1 : 0);
}

// What a run of bytes does from each entry string state e: the exit state
// (bits 2e, 2e+1 of m) and the depth change.
struct Walk {
  int m, d0, d1, d2;
};

constexpr int kIdentityMap = 0 | (1 << 2) | (2 << 4);

__device__ __forceinline__ int walk_depth(const Walk& w, int e) {
  return e == 0 ? w.d0 : (e == 1 ? w.d1 : w.d2);
}

__device__ __forceinline__ int walk_exit(const Walk& w, int e) { return (w.m >> (2 * e)) & 3; }

// a, then b
__device__ __forceinline__ Walk compose(const Walk& a, const Walk& b) {
  const int a0 = walk_exit(a, 0), a1 = walk_exit(a, 1), a2 = walk_exit(a, 2);
  Walk r;
  r.m = walk_exit(b, a0) | (walk_exit(b, a1) << 2) | (walk_exit(b, a2) << 4);
  r.d0 = a.d0 + walk_depth(b, a0);
  r.d1 = a.d1 + walk_depth(b, a1);
  r.d2 = a.d2 + walk_depth(b, a2);
  return r;
}

// A run of bytes' element marks: whether it holds a boundary, the first
// element byte after its last boundary (from its start when it holds
// none) and its last element byte, each coded (position << 1) | (byte is
// a quote), -1 for none.
struct Marks {
  int op, f, l;
};

// a, then b
__device__ __forceinline__ Marks combine(const Marks& a, const Marks& b) {
  Marks r;
  r.op = a.op | b.op;
  r.f = b.op ? b.f : (a.f >= 0 ? a.f : b.f);
  r.l = b.l >= 0 ? b.l : a.l;
  return r;
}

struct Segment {
  const uint8_t* sv;
  long long first;
  int k;
  int s;
  int step;

  // the row that owns record-absolute byte `pos`, and its column
  __device__ __forceinline__ long long flat(long long pos) const {
    long long j = pos / step;
    if (j > k - 1) j = k - 1;
    return (first + j) * (long long)s + (pos - j * step);
  }
};

// a lane's kChunk bytes of a row from column `col` (zero past the row)
__device__ __forceinline__ void load_chunk(const uint8_t* row, int col, int s, int vec,
                                           uint32_t (&w)[kChunk / 4]) {
  if (vec) {  // s % 32 == 0 and the grid 16-byte aligned: the chunk is whole
    if (col < s) {
      const uint4 a = *reinterpret_cast<const uint4*>(row + col);
      const uint4 b = *reinterpret_cast<const uint4*>(row + col + 16);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) w[q] = 0;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const int c = col + 4 * q;  // s % 4 == 0: a word is whole or past the row
    w[q] = c < s ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[kChunk / 4], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads)
    json_array_striped_kernel(const uint8_t* __restrict__ sv, const int32_t* __restrict__ owned,
                              const int32_t* __restrict__ first_row,
                              const int32_t* __restrict__ k_of, int s, int step, int vec,
                              uint8_t* __restrict__ flag, int32_t* __restrict__ start,
                              int32_t* __restrict__ elen, uint8_t* __restrict__ err) {
  __shared__ int s_fa, s_fb;
  __shared__ Walk s_walk[kWarps];
  __shared__ int s_wst[kWarps], s_wdp[kWarps];
  __shared__ Marks s_marks[kWarps], s_mpre[kWarps];
  __shared__ int s_st, s_dp, s_f, s_l;  // the carry into the next tile

  const long long seg = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = k_of[seg];
  if (k <= 0) {
    if (tid == 0) err[seg] = 0;
    return;
  }
  const Segment g{sv, (long long)first_row[seg], k, s, step};
  if (tid == 0) {
    s_fa = INT_MAX;
    s_fb = -1;
  }
  __syncthreads();

  // the outer first non-whitespace byte: tiles from the record's start
  int fa = -1;
  for (int j = 0; j < k && fa < 0; ++j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    for (int t0 = 0; t0 < own; t0 += kTile) {
      const int col = t0 + tid * kChunk;
      uint32_t w[kChunk / 4];
      load_chunk(row, col, s, vec, w);
      int best = INT_MAX;
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        if (col + i < own && !is_ws(byte_of(w, i))) best = j * step + col + i;
      }
      if (best != INT_MAX) atomicMin(&s_fa, best);
      if (__syncthreads_or(best != INT_MAX)) {
        fa = s_fa;
        break;
      }
    }
  }
  // ... and the last: tiles from the record's end
  int fb = -1;
  for (int j = k - 1; j >= 0 && fa >= 0 && fb < 0; --j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    for (int t0 = own > 0 ? (own - 1) / kTile * kTile : -1; t0 >= 0; t0 -= kTile) {
      const int col = t0 + tid * kChunk;
      uint32_t w[kChunk / 4];
      load_chunk(row, col, s, vec, w);
      int best = -1;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (col + i < own && !is_ws(byte_of(w, i))) best = j * step + col + i;
      }
      if (best >= 0) atomicMax(&s_fb, best);
      if (__syncthreads_or(best >= 0)) {
        fb = s_fb;
        break;
      }
    }
  }
  const bool ok = fa >= 0 && fb > fa && sv[g.flat(fa)] == '[' && sv[g.flat(fb)] == ']';
  if (tid == 0) {
    err[seg] = ok ? 0 : 1;
    s_st = 0;
    s_dp = 0;
    s_f = -1;
    s_l = -1;
  }
  if (!ok) return;
  __syncthreads();

  int j0 = (fa + 1) / step;
  if (j0 > k - 1) j0 = k - 1;
  bool done = false;
  for (int j = j0; j < k && !done; ++j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    const int base = j * step;
    for (int t0 = 0; t0 < own; t0 += kTile) {
      if (base + t0 > fb) {
        done = true;
        break;
      }
      const int col = t0 + tid * kChunk;
      uint32_t w[kChunk / 4];
      load_chunk(row, col, s, vec, w);

      // 1. the lane's maps from each entry state, scanned over the block
      Walk wk{kIdentityMap, 0, 0, 0};
      {
        int a0 = 0, a1 = 1, a2 = 2;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int p = base + col + i;
          if (col + i < own && p > fa && p < fb) {
            const uint32_t b = byte_of(w, i);
            const int dd = depth_step(b);
            if (a0 == 0) wk.d0 += dd;
            if (a1 == 0) wk.d1 += dd;
            if (a2 == 0) wk.d2 += dd;
            a0 = str_next(a0, b);
            a1 = str_next(a1, b);
            a2 = str_next(a2, b);
          }
        }
        wk.m = a0 | (a1 << 2) | (a2 << 4);
      }
      Walk inc = wk;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        Walk o;
        o.m = __shfl_up_sync(kFull, inc.m, off);
        o.d0 = __shfl_up_sync(kFull, inc.d0, off);
        o.d1 = __shfl_up_sync(kFull, inc.d1, off);
        o.d2 = __shfl_up_sync(kFull, inc.d2, off);
        if (lane >= off) inc = compose(o, inc);
      }
      Walk ex;
      ex.m = __shfl_up_sync(kFull, inc.m, 1);
      ex.d0 = __shfl_up_sync(kFull, inc.d0, 1);
      ex.d1 = __shfl_up_sync(kFull, inc.d1, 1);
      ex.d2 = __shfl_up_sync(kFull, inc.d2, 1);
      if (lane == 0) ex = Walk{kIdentityMap, 0, 0, 0};
      if (lane == 31) s_walk[warp] = inc;
      __syncthreads();
      if (tid == 0) {
        int st = s_st, dp = s_dp;
        for (int q = 0; q < kWarps; ++q) {
          s_wst[q] = st;
          s_wdp[q] = dp;
          dp += walk_depth(s_walk[q], st);
          st = walk_exit(s_walk[q], st);
        }
        s_st = st;
        s_dp = dp;
      }
      __syncthreads();
      int st = s_wst[warp], dp = s_wdp[warp];
      dp += walk_depth(ex, st);
      st = walk_exit(ex, st);

      // 2. boundaries and element bytes from the lane's exact entry state
      uint32_t bmask = 0, cmask = 0, qmask = 0;
      Marks mk{0, -1, -1};
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int p = base + col + i;
        if (col + i < own && p > fa && p <= fb) {
          const uint32_t b = byte_of(w, i);
          bool boundary = p == fb, element = false;
          if (!boundary) {
            boundary = st == 0 && b == ',' && dp == 0;
            if (st == 0) dp += depth_step(b);
            st = str_next(st, b);
            element = !boundary && !is_ws(b);
          }
          if (boundary) {
            bmask |= 1u << i;
            mk.op = 1;
            mk.f = -1;
          } else if (element) {
            const int code = (p << 1) | (b == '"' ? 1 : 0);
            cmask |= 1u << i;
            qmask |= (uint32_t)(code & 1) << i;
            if (mk.f < 0) mk.f = code;
            mk.l = code;
          }
        }
      }

      // 3. the open element at each lane's start, then the lane's elements
      Marks minc = mk;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        Marks o;
        o.op = __shfl_up_sync(kFull, minc.op, off);
        o.f = __shfl_up_sync(kFull, minc.f, off);
        o.l = __shfl_up_sync(kFull, minc.l, off);
        if (lane >= off) minc = combine(o, minc);
      }
      Marks mex;
      mex.op = __shfl_up_sync(kFull, minc.op, 1);
      mex.f = __shfl_up_sync(kFull, minc.f, 1);
      mex.l = __shfl_up_sync(kFull, minc.l, 1);
      if (lane == 0) mex = Marks{0, -1, -1};
      if (lane == 31) s_marks[warp] = minc;
      __syncthreads();
      if (tid == 0) {
        Marks c{1, s_f, s_l};
        for (int q = 0; q < kWarps; ++q) {
          s_mpre[q] = c;
          c = combine(c, s_marks[q]);
        }
        s_f = c.f;
        s_l = c.l;
      }
      __syncthreads();
      const Marks run = combine(s_mpre[warp], mex);
      int f = run.f, l = run.l;
      for (uint32_t ev = bmask | cmask; ev; ev &= ev - 1) {
        const int i = __ffs(ev) - 1;
        if ((bmask >> i) & 1u) {
          if (f >= 0) {
            const int quoted = (f & 1) && (l & 1) && (l >> 1) > (f >> 1) ? 1 : 0;
            const int st0 = (f >> 1) + quoted;
            const int ln = (l >> 1) - (f >> 1) + 1 - 2 * quoted;
            if (ln > 0) {
              const long long at = g.flat(st0);
              flag[at] = 1;
              start[at] = st0;
              elen[at] = ln;
            }
          }
          f = -1;
        } else {
          const int code = ((base + col + i) << 1) | (int)((qmask >> i) & 1u);
          if (f < 0) f = code;
          l = code;
        }
      }
    }
  }
}

}  // namespace

extern "C" int fluvio_json_array_striped(const void* sv, const void* owned, const void* first_row,
                                         const void* k, long long n, int s, int step, void* flag,
                                         void* start, void* elen, void* err, void* stream) {
  if (n > 0) {
    const int vec = (s % kChunk == 0 && (reinterpret_cast<uintptr_t>(sv) & 15) == 0) ? 1 : 0;
    json_array_striped_kernel<<<(unsigned)n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sv), static_cast<const int32_t*>(owned),
        static_cast<const int32_t*>(first_row), static_cast<const int32_t*>(k), s, step, vec,
        static_cast<uint8_t*>(flag), static_cast<int32_t*>(start), static_cast<int32_t*>(elen),
        static_cast<uint8_t*>(err));
  }
  return (int)cudaGetLastError();
}
