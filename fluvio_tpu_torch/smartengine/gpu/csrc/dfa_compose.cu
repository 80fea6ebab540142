// Per-row total DFA transition function over a class stream, column-split.
//
// Replaces the Pallas kernel `_dfa_compose_kernel` / `dfa_compose_columns_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:850, pl.pallas_call at
// :922). Contract of `kernels.dfa_compose_columns`: cls int32[rows, T]
// holds one symbol class per column, -1 meaning identity (padding,
// un-owned stripe bytes, bytes outside a JSON field); table_t int32[C, S]
// is the transposed transition table; out[i, s] is the state reached from
// state s after row i's columns. Per column the running vector f updates
// as f[s] = table_t[c][f[s]] when c >= 0 and stays as it is when c < 0. A
// class at or past C reads row C-1, as the XLA path clips it; no caller
// produces one. The plain torch version is `kernels.dfa_compose_columns`;
// `kernels.dfa_compose_columns_split` is the torch mirror of this split.
//
// Bound on the card: bytes. The kernel must read cls once (4 bytes a
// column) and write 4*S bytes a row; the work is one shared-memory table
// lookup per state per non-identity column.
//
// Design. Composition of transition functions is associative and exact on
// integers, so each row's T columns split into segments of `seg_len`
// columns (a multiple of 32, chosen by the entry point from S and T, see
// `seg_len_for`). Each segment's total function g[s] is computed apart,
// then the segment functions of a row are folded in column order,
// out[s] = g_{P-1}[... g_1[g_0[s]] ...] — the order is what makes the split
// equal to the serial walk.
//
// - S <= 8 (`flu[vV]io` has 8): one lane holds a whole segment function,
//   packed as two PRMT selectors, and folds a column into it with four
//   __byte_perm; a row spreads over up to 128 segments (the fat shape's
//   8,192 columns: 64 a segment, four warps a row), a warp folds its 32
//   segments with a shuffle tree (`dfa_compose_small_kernel`, below).
// - 8 < S <= 32 (`dfa_compose_split_kernel`, one lane a start state): a
//   group is `lanes` = the next power of two >= S lanes (16 or 32), and
//   32 / lanes segments share one warp. Lane s of a group loads column
//   k*lanes + s of its segment, so a group reads `lanes` consecutive
//   classes with one request, and hands each to its group's lanes with a
//   width-`lanes` __shfl_sync.
// - S > 32: a segment takes ceil(S/32) warps; each warp walks the same
//   32-column chunks for 32 of the states (the repeat reads hit L1/L2).
//
// The rest of this note is the S > 8 kernel's. Loads run ahead: a group
// issues kAhead chunk loads into registers before it consumes the first,
// so kAhead requests a warp are in flight while the lookups of the
// previous chunks run. Each lane turns its class into a table offset
// (c * S, or -1 for identity) before the shuffle. A chunk whose classes
// are identity in the whole warp is skipped on one __ballot_sync (the
// in-span path is almost all identity).
//
// A block has `slots` segment slots, and a row has at most `slots`
// segments (the segment length is chosen so), so a block holds
// `rows_per_block` whole rows, one segment a slot. Segment functions land
// in shared memory; after one __syncthreads thread (r, s) folds row r's
// segments. The table sits in shared memory as uint8 entries when
// S <= 256 and uint16 otherwise; the compiler's largest (258 classes x 257
// states x 2 bytes = 132,612 bytes) needs dynamic shared memory above
// 48 KB, which the entry point requests with cudaFuncSetAttribute before
// the launch. Every control-flow branch that reaches a shuffle or ballot
// is uniform across the warp: out-of-range columns load as identity, and
// slots past the block's last segment run the loop on identity and write
// nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAhead = 8;  // chunk loads a group keeps in flight
constexpr int kSmallStates = 8;  // up to here one lane holds a segment's whole function

struct Layout {
  int lanes;           // lanes a group (one segment's states within a warp)
  int warps_per_seg;   // warps a segment (1 when S <= 32)
  int block_warps;
  int slots;           // segments a block computes at once
};

__host__ __device__ inline Layout layout(int n_states) {
  Layout l;
  if (n_states <= 32) {
    l.lanes = 1;
    while (l.lanes < n_states) l.lanes <<= 1;
    l.warps_per_seg = 1;
  } else {
    l.lanes = 32;
    l.warps_per_seg = (n_states + 31) / 32;
  }
  const int per_block = l.warps_per_seg >= 8 ? 1 : 8 / l.warps_per_seg;
  l.block_warps = l.warps_per_seg * per_block;
  l.slots = per_block * (32 / l.lanes);
  return l;
}

// LANES (lanes a group) is a template argument so the per-chunk shuffle
// loop unrolls; it must equal layout(n_states).lanes. S > 8 only.
template <typename T, int LANES>
__global__ void dfa_compose_split_kernel(const int32_t* __restrict__ cls,
                                         const int32_t* __restrict__ table_g, int n_states,
                                         int n_classes, long long rows, int t_len, int seg_len,
                                         int n_segs, int rows_per_block,
                                         int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(n_states);
  const int entries = n_states * n_classes;
  T* table = reinterpret_cast<T*>(smem);
  T* seg_f = table + entries;  // [rows_per_block * n_segs][n_states]
  const int tid = threadIdx.x;
  for (int k = tid; k < entries; k += blockDim.x) table[k] = (T)table_g[k];
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = lane / LANES;             // segment group within the warp
  const int s_lo = lane % LANES;              // lane within the group
  const int warp_in_seg = warp % l.warps_per_seg;
  const int slot = (warp / l.warps_per_seg) * (32 / LANES) + group;
  const int state = warp_in_seg * 32 + s_lo;  // this lane's start state
  const bool live_state = state < n_states;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int chunks = seg_len / LANES;         // seg_len is a multiple of 32

  // slot = the segment task: a block's rows take at most its slots
  const long long row = row0 + slot / n_segs;
  const bool live = slot < rows_per_block * n_segs && row < rows;
  const int col0 = (slot % n_segs) * seg_len;
  const int col_end = live ? min(t_len, col0 + seg_len) : 0;
  const int32_t* crow = cls + (live ? row : 0) * (long long)t_len;
  int f = live_state ? state : 0;
  for (int k0 = 0; k0 < chunks; k0 += kAhead) {
    int off[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int col = col0 + (k0 + u) * LANES + s_lo;
      int c = (k0 + u < chunks && col < col_end) ? __ldg(crow + col) : -1;
      c = c < n_classes ? c : n_classes - 1;
      off[u] = c < 0 ? -1 : c * n_states;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (__ballot_sync(0xffffffffu, off[u] >= 0) == 0u) continue;
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        const int o = __shfl_sync(0xffffffffu, off[u], j, LANES);
        if (o >= 0) f = table[o + f];
      }
    }
  }
  if (live && live_state) seg_f[(long long)slot * n_states + state] = (T)f;
  __syncthreads();

  // fold each row's segment functions in column order
  if (tid < rows_per_block * n_states) {
    const int r = tid / n_states;
    const int s = tid % n_states;
    const long long row = row0 + r;
    if (row < rows) {
      const T* g = seg_f + (long long)r * n_segs * n_states;
      int f = s;
      for (int p = 0; p < n_segs; ++p) f = g[p * n_states + f];
      out[row * n_states + s] = f;
    }
  }
}

// S <= 8: one lane computes a whole segment function. The lane keeps the
// 8 entries of f as 3-bit nibbles in two PRMT selectors (states 0-3 and
// 4-7); a column's transition row table_t[c] is 8 bytes (uint2) in shared
// memory, so f[s] = row[f[s]] for all 8 states is two __byte_perm, and two
// more turn the result bytes back into selectors. Identity columns read an
// identity row stored past the last class, so no lane branches on them.
//
// A row's segments lie side by side, lane p of the row's `wpr` warps
// taking segment p. The warp stages its 32 segments' classes through
// shared memory 16 columns at a time: each load instruction covers 8
// segments x 64 contiguous bytes (a lane reading its own segment alone
// would touch a sector of its own per load), and the next tile's loads are
// issued before the current tile is consumed. The warp then folds its 32
// segment functions in order with a five-level shuffle tree (composition is
// two more __byte_perm), and one thread a row folds the row's warps.
constexpr int kSmallTile = 16;       // columns a lane consumes per staged tile
constexpr int kSmallPitch = 17;      // ints a tile row (conflict-free reads)
constexpr int kSmallSegs = 128;      // segments a row at most: up to 4 warps of 32 lanes
constexpr uint32_t kIdLo = 0x03020100u, kIdHi = 0x07060504u;  // identity bytes

__device__ inline uint32_t bytes_to_selector(uint32_t b) {
  const uint32_t t = b | (b >> 4);    // byte 0: b0 | b1 << 4, byte 2: b2 | b3 << 4
  return __byte_perm(t, 0u, 0x4420);  // nibbles f0 f1 f2 f3
}

struct SmallF {
  uint32_t lo = 0x3210u, hi = 0x7654u;  // identity
  __device__ inline void step(const uint2* table8, int c, int n_classes) {
    c = c < 0 ? n_classes : (c < n_classes ? c : n_classes - 1);
    const uint2 row = table8[c];
    lo = bytes_to_selector(__byte_perm(row.x, row.y, lo));
    hi = bytes_to_selector(__byte_perm(row.x, row.y, hi));
  }
  // this = after o this (this applied first)
  __device__ inline void then(uint32_t o_lo, uint32_t o_hi) {
    const uint32_t bx = __byte_perm(kIdLo, kIdHi, o_lo);  // o's entries as bytes
    const uint32_t by = __byte_perm(kIdLo, kIdHi, o_hi);
    lo = bytes_to_selector(__byte_perm(bx, by, lo));
    hi = bytes_to_selector(__byte_perm(bx, by, hi));
  }
};

// four classes of segment `seg` (row `row`) from column `col` on; -1 past
// the segment, the row or the last row
__device__ inline int4 load4(const int32_t* __restrict__ cls, long long row, long long rows,
                             int t_len, int seg_len, int n_segs, int seg, int col, int vec) {
  int4 q = make_int4(-1, -1, -1, -1);
  if (row >= rows || seg >= n_segs) return q;
  const int start = seg * seg_len;
  const int end = min(t_len, start + seg_len);
  const int c = start + col;
  const int32_t* p = cls + row * (long long)t_len;
  if (vec && c + 4 <= end) return __ldg(reinterpret_cast<const int4*>(p + c));
  if (c < end) q.x = __ldg(p + c);
  if (c + 1 < end) q.y = __ldg(p + c + 1);
  if (c + 2 < end) q.z = __ldg(p + c + 2);
  if (c + 3 < end) q.w = __ldg(p + c + 3);
  return q;
}

__global__ void dfa_compose_small_kernel(const int32_t* __restrict__ cls,
                                         const int32_t* __restrict__ table_g, int n_states,
                                         int n_classes, long long rows, int t_len, int seg_len,
                                         int n_segs, int wpr, int vec,
                                         int32_t* __restrict__ out) {
  __shared__ uint2 table8[258 + 1];
  __shared__ int tile[8][32 * kSmallPitch];
  __shared__ uint2 warp_f[8];
  const int tid = threadIdx.x;
  for (int c = tid; c <= n_classes; c += blockDim.x) {
    uint32_t w[2] = {0u, 0u};
    for (int st = 0; st < 8; ++st) {
      const uint32_t v = c == n_classes ? st : (st < n_states ? table_g[c * n_states + st] : 0);
      w[st >> 2] |= v << (8 * (st & 3));
    }
    table8[c] = make_uint2(w[0], w[1]);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows_per_block = 8 / wpr;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / wpr;
  const int seg0 = (warp % wpr) * 32;  // the warp's first segment
  int* my_tile = tile[warp];
  // the lane's share of each staged tile: segment seg0 + u*8 + lane/4,
  // columns 4*(lane%4) .. +3 of the tile
  const int ld_seg = lane >> 2;
  const int ld_col = (lane & 3) * 4;
  int4 next[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    next[u] = load4(cls, row, rows, t_len, seg_len, n_segs, seg0 + u * 8 + ld_seg, ld_col, vec);
  SmallF f;
  for (int c0 = 0; c0 < seg_len; c0 += kSmallTile) {  // uniform across the warp
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int* d = my_tile + (u * 8 + ld_seg) * kSmallPitch + ld_col;
      d[0] = next[u].x;
      d[1] = next[u].y;
      d[2] = next[u].z;
      d[3] = next[u].w;
    }
    __syncwarp();
    if (c0 + kSmallTile < seg_len) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        next[u] = load4(cls, row, rows, t_len, seg_len, n_segs, seg0 + u * 8 + ld_seg,
                        c0 + kSmallTile + ld_col, vec);
    }
    const int* mine = my_tile + lane * kSmallPitch;
#pragma unroll
    for (int c = 0; c < kSmallTile; ++c) f.step(table8, mine[c], n_classes);
  }
  // fold the warp's 32 segments in order: lane l absorbs lane l + d
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o_lo = __shfl_down_sync(0xffffffffu, f.lo, d);
    const uint32_t o_hi = __shfl_down_sync(0xffffffffu, f.hi, d);
    if ((lane & (2 * d - 1)) == 0) f.then(o_lo, o_hi);
  }
  if (lane == 0) warp_f[warp] = make_uint2(f.lo, f.hi);
  __syncthreads();
  // fold each row's warps in order and write the row
  if (tid < rows_per_block) {
    const long long r = (long long)blockIdx.x * rows_per_block + tid;
    if (r < rows) {
      SmallF g;
      g.lo = warp_f[tid * wpr].x;
      g.hi = warp_f[tid * wpr].y;
      for (int w = 1; w < wpr; ++w) g.then(warp_f[tid * wpr + w].x, warp_f[tid * wpr + w].y);
      for (int st = 0; st < n_states; ++st)
        out[r * n_states + st] = ((st < 4 ? g.lo : g.hi) >> (4 * (st & 3))) & 7u;
    }
  }
}

// Columns a segment, a multiple of 32: a row's T columns spread over up to
// kSmallSegs segments when a lane holds a segment (S <= 8), else over at
// most the block's slots, so a block holds whole rows.
int seg_len_for(int n_states, int t_len) {
  const int segs = n_states <= kSmallStates ? kSmallSegs : layout(n_states).slots;
  const int per_seg = ((t_len > 1 ? t_len : 1) + segs - 1) / segs;
  return (per_seg + 31) / 32 * 32;
}

int launch_small(const void* cls, const void* table_t, int n_states, int n_classes,
                 long long rows, int t_len, void* out, cudaStream_t stream) {
  const int seg_len = seg_len_for(n_states, t_len);
  const int n_segs = t_len > 0 ? (t_len + seg_len - 1) / seg_len : 1;
  if (n_classes > 258) return (int)cudaErrorInvalidValue;
  int wpr = 1;  // warps a row: a power of two, so rows tile the block's 8 warps
  while (wpr * 32 < n_segs) wpr <<= 1;
  const int rows_per_block = 8 / wpr;
  const int vec = (t_len % 4 == 0) && (reinterpret_cast<uintptr_t>(cls) % 16 == 0);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  dfa_compose_small_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const int32_t*>(cls), static_cast<const int32_t*>(table_t), n_states,
      n_classes, rows, t_len, seg_len, n_segs, wpr, vec, static_cast<int32_t*>(out));
  return 0;
}

template <typename T, int LANES>
int launch(const void* cls, const void* table_t, int n_states, int n_classes, long long rows,
           int t_len, void* out, cudaStream_t stream) {
  const Layout l = layout(n_states);
  const int seg_len = seg_len_for(n_states, t_len);
  const int n_segs = t_len > 0 ? (t_len + seg_len - 1) / seg_len : 1;  // <= l.slots
  const int rows_per_block = l.slots / n_segs;
  const size_t smem =
      ((size_t)n_states * n_classes + (size_t)rows_per_block * n_segs * n_states) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dfa_compose_split_kernel<T, LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  dfa_compose_split_kernel<T, LANES><<<(unsigned)blocks, l.block_warps * 32, smem, stream>>>(
      static_cast<const int32_t*>(cls), static_cast<const int32_t*>(table_t), n_states,
      n_classes, rows, t_len, seg_len, n_segs, rows_per_block, static_cast<int32_t*>(out));
  return 0;
}

}  // namespace

// cls int32[rows, t_len], table_t int32[n_classes, n_states] -> out int32[rows, n_states].
extern "C" int fluvio_dfa_compose(const void* cls, const void* table_t, int n_states,
                                  int n_classes, long long rows, int t_len, void* out,
                                  void* stream) {
  if (rows > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLUVIO_COMPOSE(T, L) \
  launch<T, L>(cls, table_t, n_states, n_classes, rows, t_len, out, st)
    int rc;
    if (n_states <= kSmallStates) {
      rc = launch_small(cls, table_t, n_states, n_classes, rows, t_len, out, st);
    } else if (n_states <= 16) {
      rc = FLUVIO_COMPOSE(uint8_t, 16);
    } else {
      rc = n_states <= 256 ? FLUVIO_COMPOSE(uint8_t, 32) : FLUVIO_COMPOSE(uint16_t, 32);
    }
#undef FLUVIO_COMPOSE
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
