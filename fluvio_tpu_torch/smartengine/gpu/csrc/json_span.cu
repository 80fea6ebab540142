// JSON top-level field span on the card: two entry points, three designs.
//
// `fluvio_json_span` replaces the Pallas kernel `_json_scan_kernel` /
// `json_get_span_pallas` (fluvio_tpu/smartengine/tpu/pallas_kernels.py:100,
// pl.pallas_call at :316); `fluvio_json_span_striped` replaces no Pallas
// kernel: the JAX package runs it as an XLA lax.scan over the striped
// wide-record layout (`stripes.striped_json_span`,
// fluvio_tpu/smartengine/tpu/stripes.py:263). Both follow the JAX package's
// sequential machine (`kernels.json_step` / `json_span_finalize`,
// kernels.py:370-528): find "key" at brace depth 1, skip ':' and
// whitespace, then a string value runs to its closing quote and a raw value
// to the next top-level , ] or }, trimmed of space, tab, CR and LF (not \x0b
// or \x0c); an unterminated value closes at the end of the record. Where the
// Pallas kernel differs from that machine (a dropped colon-abort byte, a key
// holding a backslash or a quote compared byte for byte) the kernels follow
// the XLA machine. Plain torch versions: `kernels.json_get_span` and
// `kernels.striped_json_span`; chip_smoke.py holds every design to them
// exactly.
//
// Bound on the card: bytes, the bytes a record needs read up to the end of
// its field (the whole record when the key is missing), plus the lengths
// and the two outputs. The launcher picks one of two designs by the width.
//
// 1. A thread a record (`json_span_kernel`, narrow rows up to
//    kWarpDesignWidth bytes, the main path's 64-byte rows among them). A
//    warp stages its 32 rows through a shared-memory tile one 32-byte column
//    chunk at a time (16-byte loads, neighbouring lanes on neighbouring
//    addresses; rows padded to 36 bytes, so the per-thread word reads hit 32
//    banks), and loads the next chunk only while a lane is still short of
//    its field's end. Each thread then steps its row's bytes through the
//    machine, read as words out of the tile with static byte shifts (a
//    register vector indexed at run time would sit on a stack frame): a
//    256-entry class table in shared memory replaces the compare chain, and
//    the step branches on the phase, so the common byte costs the tests of
//    its phase only (the branch-free `where` chain of kernels.json_step
//    over the same tile ran ~4x slower on the H100; PERF.md). Inside a
//    string value, or a string that is no key candidate, a word with no
//    quote and no backslash is skipped whole after two byte tests.
//
// 2. A warp a record (`json_span_warp_kernel`, wider narrow rows, and every
//    striped segment). One thread walking a record byte by byte has only its
//    own dependent chain to run, so a late key in a 60 KB row or a 70 KB
//    segment costs milliseconds with the card nearly idle. The warp walks the
//    record 1 KB at a time (32 bytes a lane, loads two chunks ahead),
//    computes the machine's result inside the chunk in parallel, and
//    carries a small state across chunks and stripe joints. Why this is
//    exact:
//
//    a. String state. (in_str, esc) takes three values: A (outside), B
//       (inside), C (inside, after a backslash). Every byte maps the three
//       states: a quote A->B, B->A, C->B; a backslash A->A, B->C, C->B; any
//       other byte A->A, B->B, C->B. Maps compose associatively, so each
//       lane composes its bytes' maps, a shuffle scan over the lanes gives
//       every lane its entry state from the carried one, and each lane then
//       knows the state before each of its bytes exactly. A backslash acts
//       only inside a string; the odd-backslash-run rule of simdjson treats
//       `\"` outside a string as escaped, which this machine does not. In a
//       chunk without a backslash the map of every quote is the flip of A
//       and B (after a carried C has consumed the chunk's first byte), so a
//       ballot of the lanes' quote parities and a prefix XOR inside the lane
//       give the same states without the scan.
//    b. Depth: '{' minus '}' outside strings, a reduction for the carry and
//       a shuffle prefix only in chunks with a quote that opens a string.
//    c. Key candidates: a quote opening a string (state A) at depth 1 whose
//       next klen - 2 bytes equal the key and whose next byte closes it.
//       That is exactly what the machine's progressive match accepts: it
//       restarts at 0 on any mismatch, a backslash or a quote inside the
//       string, so a key holding a backslash or a quote never matches (the
//       wrapper checks the key once), and the empty key matches "". The
//       comparison reads the staged chunk; one that runs off the chunk's
//       end carries its progress into the next chunk (strings never nest,
//       so at most one is open).
//    d. Colon: after a candidate, whitespace then ':' moves on to the value;
//       any other byte aborts and is scanned again as the general machine
//       scans it. The general state the lanes computed is still right there,
//       because whitespace and ':' never change the string state or the
//       depth. The first candidate to reach its colon wins.
//    e. Value: a string value's state is the general machine's (it opens
//       from state A), so it ends at the first quote in state B. A raw value
//       ends at the first ']', '}' or ',' where its own bracket depth d2
//       ('[' and '{' up, ']' and '}' down, strings ignored) is zero: a
//       shuffle prefix again, a lane walking only its bracket bytes. The end
//       trims back to the last non-whitespace byte before it (a ballot for
//       the last lane with one). Unterminated values end as
//       `json_span_finalize` ends them.
//    f. A chunk with none of '"' '\' '{' '}' changes nothing while the warp
//       scans for a key or walks a string value, but a carried C: the warp
//       skips it after the test (the body of a 70 KB string costs a load
//       and four byte tests a word).
//    The chunk's events (candidate, colon, value start, value end) are
//    found in order by ballots over 32-bit lane masks; bytes are classed
//    four at a time by exact zero-byte tests. tests/test_torch_json_redesign.py
//    models this walk in numpy (32- and 1,024-byte chunks, the parity path,
//    stripe joints) and holds it to the plain versions, the XLA kernel and
//    the Pallas kernel.
//
// The width threshold: on the H100 the warp design was the faster from
// rows of 1 KB on, and ~200x so at rows of 60 KB (PERF.md).
//
// The needle (the key in quotes) sits in shared memory where it fits beside
// the kernel's own shared memory, up to the device's opt-in maximum a block
// (227 KB on the H100); a longer one stays in global memory, where the
// kernels read it through the cache. Both hold any key up to the 1 MiB
// record ceiling.
//
// Striped layout: a segment's owned bytes of stripe rows first_row ..
// first_row + k - 1, in order (the overlap tail of a non-last row belongs to
// the next row), at record positions kk * step + j; the start clips to the
// record length.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P_SCAN = 0, P_COLON = 1, P_WS = 2, P_STR = 3, P_RAW = 4, P_DONE = 5;
constexpr unsigned kFull = 0xFFFFFFFFu;

// narrow rows wider than this take the warp-per-record design
constexpr int kWarpDesignWidth = 512;

__device__ __forceinline__ uint32_t rep4(uint32_t c) { return c * 0x01010101u; }

// 0x80 in each byte of w equal to the byte repeated in rep (exact)
__device__ __forceinline__ uint32_t eq4(uint32_t w, uint32_t rep) {
  const uint32_t t = w ^ rep;
  return ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
}

// The needle the kernel reads: copied into the block's shared memory at
// `smem_needle` when the launcher gave it room (`staged`), else the global
// copy. The caller synchronises the block before the first read.
__device__ __forceinline__ const uint8_t* stage_needle(uint8_t* smem_needle,
                                                       const uint8_t* needle_g, int klen,
                                                       int staged) {
  if (!staged) return needle_g;
  for (int k = threadIdx.x; k < klen; k += blockDim.x) smem_needle[k] = needle_g[k];
  return smem_needle;
}

// ---------------------------------------------------------------------------
// 1. a thread a record
// ---------------------------------------------------------------------------

enum : uint8_t {
  K_OTHER, K_WS, K_QUOTE, K_BSLASH, K_LBRACE, K_RBRACE, K_LBRACKET, K_RBRACKET, K_COMMA, K_COLON
};

__device__ __forceinline__ uint8_t class_of(int c) {
  switch (c) {
    case ' ': case '\t': case '\r': case '\n': return K_WS;
    case '"': return K_QUOTE;
    case '\\': return K_BSLASH;
    case '{': return K_LBRACE;
    case '}': return K_RBRACE;
    case '[': return K_LBRACKET;
    case ']': return K_RBRACKET;
    case ',': return K_COMMA;
    case ':': return K_COLON;
    default: return K_OTHER;
  }
}

struct JsonMachine {
  int phase = P_SCAN;
  int kmatch = 0;
  bool in_str = false;
  bool esc = false;
  int depth = 0;
  int d2 = 0;
  bool vesc = false;
  int start = 0;
  int end = 0;
  int lastnw = -1;

  // The general scan (phase SCAN, or the byte that aborts a colon search):
  // the updates of kernels.json_step's in-string / outside-string branches.
  __device__ __forceinline__ void scan(int c, int k, const uint8_t* needle, int klen) {
    if (!in_str) {
      if (k == K_QUOTE) {
        in_str = true;
        kmatch = depth == 1 ? 1 : 0;
      } else if (k == K_LBRACE) {
        ++depth;
      } else if (k == K_RBRACE) {
        --depth;
      }
    } else if (esc) {
      esc = false;
      kmatch = 0;
    } else if (k == K_BSLASH) {
      esc = true;
      kmatch = 0;
    } else if (k == K_QUOTE) {
      in_str = false;
      if (kmatch == klen - 1) phase = P_COLON;
      kmatch = 0;
    } else {
      kmatch = (kmatch > 0 && kmatch < klen - 1 && c == needle[kmatch]) ? kmatch + 1 : 0;
    }
  }

  // One byte of class k at record position t.
  __device__ __forceinline__ void step(int c, int k, int t, const uint8_t* needle, int klen) {
    switch (phase) {
      case P_SCAN:
        scan(c, k, needle, klen);
        break;
      case P_COLON:
        if (k == K_WS) break;
        if (k == K_COLON) {
          phase = P_WS;
          break;
        }
        phase = P_SCAN;
        scan(c, k, needle, klen);
        break;
      case P_WS:
        if (k == K_WS) break;
        if (k == K_QUOTE) {
          phase = P_STR;
          start = t + 1;
        } else if (k == K_RBRACKET || k == K_RBRACE || k == K_COMMA) {
          phase = P_DONE;
          start = t;
          end = t;
        } else {
          phase = P_RAW;
          start = t;
          lastnw = t;
          d2 += (k == K_LBRACKET || k == K_LBRACE) ? 1 : 0;
        }
        break;
      case P_STR:
        if (vesc) {
          vesc = false;
        } else if (k == K_BSLASH) {
          vesc = true;
        } else if (k == K_QUOTE) {
          end = t;
          phase = P_DONE;
        }
        break;
      case P_RAW:
        if (k == K_LBRACKET || k == K_LBRACE) {
          ++d2;
          lastnw = t;
        } else if (k == K_RBRACKET || k == K_RBRACE || k == K_COMMA) {
          if (d2 == 0) {
            end = lastnw + 1;
            phase = P_DONE;
          } else {
            if (k != K_COMMA) --d2;
            lastnw = t;
          }
        } else if (k != K_WS) {
          lastnw = t;
        }
        break;
      default:
        break;
    }
  }
};

constexpr int kThreadWarps = 8;   // warps a block
constexpr int kTileChunk = 32;    // bytes of a row staged at a time
constexpr int kTileWords = 9;     // a row's words in the tile: word w of the 32 rows in 32 banks

__global__ void __launch_bounds__(kThreadWarps * 32)
json_span_kernel(const uint8_t* __restrict__ values, const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ needle_g, int klen, int staged, long long n,
                 int width, int vec, int32_t* __restrict__ start_out,
                 int32_t* __restrict__ vlen_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem);
  uint8_t* cls = smem + kThreadWarps * 32 * kTileWords * 4;
  const uint8_t* needle = stage_needle(cls + 256, needle_g, klen, staged);
  for (int k = threadIdx.x; k < 256; k += blockDim.x) cls[k] = class_of(k);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * kThreadWarps + warp) * 32;
  if (row0 >= n) return;
  uint32_t* tile = tiles + warp * 32 * kTileWords;
  const long long i = row0 + lane;
  const bool has = i < n;
  const int len = has ? lengths[i] : 0;
  const int lim = len < 0 ? 0 : (len < width ? len : width);
  JsonMachine m;

  for (int c0 = 0;; c0 += kTileChunk) {
    const bool want = has && m.phase != P_DONE && c0 < lim;
    const unsigned need = __ballot_sync(kFull, want);
    if (!need) break;
    if (vec) {
      // 32 rows x 32 bytes = 64 pieces of 16 bytes, two a lane
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h, r = p >> 1, col = c0 + 16 * (p & 1);
        if (((need >> r) & 1u) && col < width) {
          const uint4 x = *reinterpret_cast<const uint4*>(values + (row0 + r) * width + col);
          uint32_t* dst = tile + r * kTileWords + 4 * (p & 1);
          dst[0] = x.x;
          dst[1] = x.y;
          dst[2] = x.z;
          dst[3] = x.w;
        }
      }
    } else {
      // unaligned rows: the warp reads each live row's 32 bytes with byte loads
      uint8_t* bytes = reinterpret_cast<uint8_t*>(tile);
      for (int r = 0; r < 32; ++r) {
        if (!((need >> r) & 1u)) continue;
        const int col = c0 + lane;
        bytes[r * kTileWords * 4 + lane] = col < width ? values[(row0 + r) * width + col] : 0;
      }
    }
    __syncwarp();
    if (want) {
      const int stop = lim - c0 < kTileChunk ? lim - c0 : kTileChunk;
      const uint32_t* row = tile + lane * kTileWords;
      for (int w = 0; 4 * w < stop && m.phase != P_DONE; ++w) {
        const uint32_t word = row[w];
        // a word with no quote and no backslash changes nothing inside a
        // string value, or inside a string that is no key candidate
        if (((m.phase == P_STR && !m.vesc) ||
             (m.phase == P_SCAN && m.in_str && !m.esc && m.kmatch == 0)) &&
            !(eq4(word, rep4('"')) | eq4(word, rep4('\\'))))
          continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * w + b;
          const int c = (word >> (8 * b)) & 0xFF;
          if (j < stop) m.step(c, cls[c], c0 + j, needle, klen);
        }
      }
    }
    __syncwarp();
  }
  if (!has) return;
  // end of record: unterminated values run to the end
  int end = m.end;
  if (m.phase == P_STR) end = len;
  if (m.phase == P_RAW) end = m.lastnw + 1;
  const bool found = (m.phase == P_DONE) | (m.phase == P_STR) | (m.phase == P_RAW);
  const int span = end - m.start;
  vlen_out[i] = found ? (span > 0 ? span : 0) : 0;
  start_out[i] = m.start < 0 ? 0 : (m.start > width ? width : m.start);
}

// ---------------------------------------------------------------------------
// 2. a warp a record
// ---------------------------------------------------------------------------

constexpr int kLaneBytes = 32;
constexpr int kChunk = 32 * kLaneBytes;  // bytes a warp walks at a time
constexpr int kRecordWarps = 4;          // warps (records) a block
constexpr int S_A = 0, S_B = 1, S_C = 2;  // outside a string, inside, after a backslash
// packed 3-state maps: 2 bits, the image of A, B and C in turn
constexpr uint32_t kMapId = 0u | 1u << 2 | 2u << 4;
constexpr uint32_t kMapPlain = 0u | 1u << 2 | 1u << 4;  // any run of other bytes

__device__ __forceinline__ uint32_t map_apply(uint32_t f, uint32_t s) { return (f >> (2 * s)) & 3u; }

// g after f
__device__ __forceinline__ uint32_t map_compose(uint32_t g, uint32_t f) {
  return map_apply(g, f & 3u) | map_apply(g, (f >> 2) & 3u) << 2 | map_apply(g, (f >> 4) & 3u) << 4;
}

// the four 0x80 flags of eq4 as four bits
__device__ __forceinline__ uint32_t pack4(uint32_t m) { return (((m >> 7) * 0x00204081u) >> 21) & 0xFu; }

// The lane's 32 bytes as eight little-endian words; bit j of a mask is byte j.
struct LaneBytes {
  uint32_t w[8];

  __device__ __forceinline__ uint32_t eq(uint32_t c) const {
    const uint32_t r = rep4(c);
    uint32_t out = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) out |= pack4(eq4(w[q], r)) << (4 * q);
    return out;
  }
  __device__ __forceinline__ uint32_t ws() const {
    uint32_t out = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t m = eq4(w[q], rep4(' ')) | eq4(w[q], rep4('\t')) | eq4(w[q], rep4('\r')) |
                         eq4(w[q], rep4('\n'));
      out |= pack4(m) << (4 * q);
    }
    return out;
  }
  // any byte that can change the string state or the depth: " \ { }
  __device__ __forceinline__ bool structural() const {
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      m |= eq4(w[q], rep4('"')) | eq4(w[q], rep4('\\')) | eq4(w[q], rep4('{')) |
           eq4(w[q], rep4('}'));
    return m != 0;
  }
};

// lane bits lo .. hi-1, clipped to 0..31
__device__ __forceinline__ uint32_t range32(int lo, int hi) {
  if (hi <= 0 || lo >= 32 || lo >= hi) return 0u;
  const uint32_t below_hi = hi >= 32 ? 0xFFFFFFFFu : (1u << hi) - 1u;
  const uint32_t from_lo = lo <= 0 ? 0xFFFFFFFFu : ~((1u << lo) - 1u);
  return below_hi & from_lo;
}

// bit j: the parity of the set bits below j
__device__ __forceinline__ uint32_t parity_below(uint32_t x) {
  uint32_t p = x;
  p ^= p << 1;
  p ^= p << 2;
  p ^= p << 4;
  p ^= p << 8;
  p ^= p << 16;
  return p ^ x;
}

// first chunk byte >= p whose bit is set (bit k of lane l is byte 32 l + k)
__device__ __forceinline__ int warp_first(uint32_t m32, int p, int lane) {
  const uint32_t m = m32 & range32(p - kLaneBytes * lane, kLaneBytes);
  const unsigned ball = __ballot_sync(kFull, m != 0);
  if (!ball) return -1;
  const int fl = __ffs(ball) - 1;
  return kLaneBytes * fl + __shfl_sync(kFull, __ffs(m) - 1, fl);
}

// last chunk byte in [p, q) whose bit is set
__device__ __forceinline__ int warp_last(uint32_t m32, int p, int q, int lane) {
  const uint32_t m = m32 & range32(p - kLaneBytes * lane, q - kLaneBytes * lane);
  const unsigned ball = __ballot_sync(kFull, m != 0);
  if (!ball) return -1;
  const int fl = 31 - __clz(ball);
  return kLaneBytes * fl + __shfl_sync(kFull, 31 - __clz(m), fl);
}

__device__ __forceinline__ int warp_sum_excl(int v, int lane) {
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += o;
  }
  return s - v;
}

// x[0..n) == y[0..n), the warp comparing 32 bytes a step
__device__ __forceinline__ bool warp_equal(const uint8_t* x, const uint8_t* y, int n, int lane) {
  for (int o = 0; o < n; o += 32) {
    const int j = o + lane;
    if (__any_sync(kFull, j < n && x[j] != y[j])) return false;
  }
  return true;
}

// The warp's carried state (the same in every lane).
struct WarpCarry {
  int mode = P_SCAN;
  int sst = S_A;    // string state before the next chunk
  int depth = 0;    // brace depth before the next chunk
  int kpend = 0;    // needle bytes an open candidate has matched (0: none)
  int d2 = 0;       // a raw value's bracket depth
  int lastnw = -1;  // a raw value's last non-whitespace position
  int start = 0;
  int end = 0;
};

// String states of the lane's valid bytes: `outside` (state A before the
// byte), and the quotes that open (qa) and close (qb) a string. Returns the
// state after the chunk. Exact: the three-state map scan where the chunk
// holds a backslash; else quote parity, which is the same map there.
__device__ __forceinline__ int string_states(const LaneBytes& b, uint32_t valid, int sst,
                                             int lane, uint32_t* outside, uint32_t* qa,
                                             uint32_t* qb) {
  uint32_t q = b.eq('"') & valid;
  const uint32_t bs = b.eq('\\') & valid;
  if (!__any_sync(kFull, bs != 0)) {
    // no backslash: every quote flips A and B; a carried C takes the
    // chunk's first byte as escaped and leaves B
    uint32_t s0 = (uint32_t)sst;
    if (sst == S_C) {
      s0 = S_B;
      if (lane == 0) q &= ~1u;
    }
    const unsigned odd = __ballot_sync(kFull, __popc(q) & 1);
    const uint32_t s_in = s0 ^ (__popc(odd & ((1u << lane) - 1u)) & 1u);
    uint32_t inside = parity_below(q) ^ (s_in ? 0xFFFFFFFFu : 0u);
    if (sst == S_C && lane == 0) inside |= 1u;
    *outside = valid & ~inside;
    *qa = q & *outside;
    *qb = q & inside & valid;
    return (int)(s0 ^ (__popc(odd) & 1u));
  }
  uint32_t f;
  if (!(q | bs)) {
    f = valid ? kMapPlain : kMapId;
  } else {
    uint32_t xa = 1u, xb = 2u, xc = 4u;  // which entry states' walks are in A, B, C
#pragma unroll
    for (int k = 0; k < kLaneBytes; ++k) {
      if ((valid >> k) & 1u) {
        const bool qk = (q >> k) & 1u, bk = (bs >> k) & 1u;
        const uint32_t na = qk ? xb : xa;
        const uint32_t nb = qk ? (xa | xc) : (bk ? xc : (xb | xc));
        const uint32_t nc = bk ? xb : 0u;
        xa = na;
        xb = nb;
        xc = nc;
      }
    }
    f = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s)
      f |= (((xa >> s) & 1u) ? 0u : (((xb >> s) & 1u) ? 1u : 2u)) << (2 * s);
  }
  uint32_t scan = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan = map_compose(scan, o);
  }
  const uint32_t prev = __shfl_up_sync(kFull, scan, 1);
  const uint32_t s_in = lane == 0 ? (uint32_t)sst : map_apply(prev, sst);
  uint32_t out = 0, open = 0, close = 0, s = s_in;
#pragma unroll
  for (int k = 0; k < kLaneBytes; ++k) {
    if ((valid >> k) & 1u) {
      const bool qk = (q >> k) & 1u, bk = (bs >> k) & 1u;
      if (s == S_A) out |= 1u << k;
      if (qk && s == S_A) open |= 1u << k;
      if (qk && s == S_B) close |= 1u << k;
      s = s == S_C ? S_B : (qk ? (s == S_A ? S_B : S_A) : ((bk && s == S_B) ? S_C : s));
    }
  }
  *outside = out;
  *qa = open;
  *qb = close;
  return (int)map_apply(__shfl_sync(kFull, scan, 31), sst);
}

// One chunk of cl bytes (staged in buf; the lane's 32 in b) at record
// positions pos0.. through the machine.
__device__ __forceinline__ void warp_chunk(WarpCarry& st, const LaneBytes& b, const uint8_t* buf,
                                           int cl, int pos0, const uint8_t* needle, int klen,
                                           bool matchable, int lane) {
  const uint32_t valid = range32(0, cl - kLaneBytes * lane);
  // a string body or any run without " \ { }: nothing to find while
  // scanning or inside a string value; a carried escape consumes byte 0
  if ((st.mode == P_SCAN && !st.kpend) || st.mode == P_STR) {
    if (!__any_sync(kFull, b.structural())) {
      if (st.sst == S_C) st.sst = S_B;
      return;
    }
  }
  uint32_t qb = 0, cand = 0;
  int sst_out = st.sst, depth_total = 0;
  if (st.mode != P_RAW) {
    // a. string states, b. depth, c. key candidates at depth 1
    uint32_t outside, qa;
    sst_out = string_states(b, valid, st.sst, lane, &outside, &qa, &qb);
    const uint32_t lba = b.eq('{') & outside, rba = b.eq('}') & outside;
    const int delta = __popc(lba) - __popc(rba);
    depth_total = __reduce_add_sync(kFull, delta);
    if (matchable && __any_sync(kFull, qa != 0)) {
      const int depth_in = st.depth + warp_sum_excl(delta, lane);
      for (uint32_t m = qa; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const uint32_t below = (1u << k) - 1u;
        if (depth_in + __popc(lba & below) - __popc(rba & below) == 1) cand |= 1u << k;
      }
    }
  }

  uint32_t nonws = 0;
  bool have_nonws = false;
  int p = 0;
  while (st.mode != P_DONE) {
    if (st.mode == P_SCAN) {
      if (st.kpend) {  // a candidate open across the chunk's start
        const int need = klen - st.kpend, nb = need < cl ? need : cl;
        if (warp_equal(buf, needle + st.kpend, nb, lane)) {
          if (nb == need) {
            st.mode = P_COLON;
            st.kpend = 0;
            p = nb;
            continue;
          }
          st.kpend += nb;
          break;
        }
        st.kpend = 0;
      }
      const int j = warp_first(cand, p, lane);
      if (j < 0) break;
      const int need = klen - 1, avail = cl - j - 1, nb = need < avail ? need : avail;
      if (warp_equal(buf + j + 1, needle + 1, nb, lane)) {
        if (nb == need) {
          st.mode = P_COLON;
          p = j + klen;
          continue;
        }
        st.kpend = 1 + nb;
        break;
      }
      p = j + 1;
      continue;
    }
    if (st.mode == P_STR) {
      const int j = warp_first(qb, p, lane);
      if (j < 0) break;
      st.mode = P_DONE;
      st.end = pos0 + j;
      break;
    }
    if (!have_nonws) {
      nonws = ~b.ws() & valid;
      have_nonws = true;
    }
    if (st.mode == P_COLON || st.mode == P_WS) {
      const int j = warp_first(nonws, p, lane);
      if (j < 0) break;
      const int c = buf[j];
      if (st.mode == P_COLON) {
        if (c == ':') {
          st.mode = P_WS;
          p = j + 1;
        } else {
          st.mode = P_SCAN;  // the byte is scanned again by the general machine
          p = j;
        }
      } else if (c == '"') {
        st.mode = P_STR;
        st.start = pos0 + j + 1;
        p = j + 1;
      } else if (c == ']' || c == '}' || c == ',') {
        st.mode = P_DONE;
        st.start = pos0 + j;
        st.end = pos0 + j;
      } else {
        st.mode = P_RAW;
        st.start = pos0 + j;
        st.lastnw = pos0 + j;
        st.d2 = (c == '[' || c == '{') ? 1 : 0;
        p = j + 1;
      }
      continue;
    }
    // P_RAW: the first ] } , at bracket depth 0 (strings ignored)
    const uint32_t from = range32(p - kLaneBytes * lane, kLaneBytes) & valid;
    const uint32_t o = (b.eq('[') | b.eq('{')) & from;
    const uint32_t c = (b.eq(']') | b.eq('}')) & from;
    const uint32_t e = b.eq(',') & from;
    const int delta = __popc(o) - __popc(c);
    int d = st.d2 + warp_sum_excl(delta, lane);
    int mine = -1;
    for (uint32_t ev = o | c | e; ev; ev &= ev - 1) {
      const int k = __ffs(ev) - 1;
      const uint32_t bit = 1u << k;
      if (bit & o) {
        ++d;
      } else if (d == 0) {
        mine = k;
        break;
      } else if (bit & c) {
        --d;
      }
    }
    const unsigned ball = __ballot_sync(kFull, mine >= 0);
    const int j = ball ? kLaneBytes * (__ffs(ball) - 1) + __shfl_sync(kFull, mine, __ffs(ball) - 1)
                       : -1;
    const int last = warp_last(nonws, p, j < 0 ? cl : j, lane);
    if (last >= 0) st.lastnw = pos0 + last;
    if (j >= 0) {
      st.mode = P_DONE;
      st.end = st.lastnw + 1;
    } else {
      st.d2 += __reduce_add_sync(kFull, delta);
    }
    break;
  }
  st.sst = sst_out;
  st.depth += depth_total;
}

// Where the warp's bytes come from: a record's pieces (stripe rows, or the
// one narrow row) walked a chunk at a time.
struct Cursor {
  const uint8_t* base;  // piece 0's first byte
  long long pitch;      // bytes from one piece to the next
  int step;             // record positions from one piece to the next
  int pieces;
  const int32_t* owned;  // bytes of each piece (null: `lim` for the one piece)
  int kk = 0, off = 0, lim = 0;

  __device__ __forceinline__ bool ok() const { return kk < pieces; }
  __device__ __forceinline__ int cl() const { return lim - off < kChunk ? lim - off : kChunk; }
  __device__ __forceinline__ const uint8_t* ptr() const { return base + kk * pitch + off; }
  __device__ __forceinline__ int pos() const { return kk * step + off; }
  // on to the next non-empty chunk
  __device__ __forceinline__ void settle() {
    while (kk < pieces && off >= lim) {
      ++kk;
      off = 0;
      if (kk < pieces) lim = owned ? owned[kk] : lim;
    }
  }
  __device__ __forceinline__ Cursor next() const {
    Cursor c = *this;
    if (c.ok()) {
      c.off += kChunk;
      c.settle();
    }
    return c;
  }
};

// The lane's 32 bytes of a chunk, with 16-byte loads where rows allow them.
struct Pair {
  uint4 lo, hi;
};

__device__ __forceinline__ Pair load_lane(const Cursor& cur, bool vec, int lane) {
  Pair x{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (vec && cur.ok()) {
    const int cl = cur.cl(), j = kLaneBytes * lane;
    const uint8_t* src = cur.ptr() + j;
    if (j < cl) x.lo = *reinterpret_cast<const uint4*>(src);
    if (j + 16 < cl) x.hi = *reinterpret_cast<const uint4*>(src + 16);
  }
  return x;
}

// One record through the warp; lane 0 writes (start, vlen).
__device__ __forceinline__ void warp_record(Cursor cur, bool vec, int len, int start_cap,
                                            uint8_t* buf, const uint8_t* needle, int klen,
                                            bool matchable, int lane, int32_t* start_out,
                                            int32_t* vlen_out) {
  WarpCarry st;
  cur.settle();
  Cursor c1 = cur.next();
  Pair x0 = load_lane(cur, vec, lane), x1 = load_lane(c1, vec, lane);
  while (cur.ok() && st.mode != P_DONE) {
    const Cursor c2 = c1.next();
    const Pair x2 = load_lane(c2, vec, lane);  // two chunks ahead, in flight
    const int cl = cur.cl();
    uint4* mine = reinterpret_cast<uint4*>(buf + kLaneBytes * lane);
    if (!vec) {
      const uint8_t* src = cur.ptr();
      for (int j = lane; j < kChunk; j += 32) buf[j] = j < cl ? src[j] : 0;
      __syncwarp();
      x0.lo = mine[0];
      x0.hi = mine[1];
    } else {
      mine[0] = x0.lo;
      mine[1] = x0.hi;
    }
    __syncwarp();
    const LaneBytes b{{x0.lo.x, x0.lo.y, x0.lo.z, x0.lo.w, x0.hi.x, x0.hi.y, x0.hi.z, x0.hi.w}};
    warp_chunk(st, b, buf, cl, cur.pos(), needle, klen, matchable, lane);
    __syncwarp();
    cur = c1;
    c1 = c2;
    x0 = x1;
    x1 = x2;
  }
  if (lane != 0) return;
  int end = st.end;
  if (st.mode == P_STR) end = len;
  if (st.mode == P_RAW) end = st.lastnw + 1;
  const bool found = (st.mode == P_DONE) | (st.mode == P_STR) | (st.mode == P_RAW);
  const int span = end - st.start;
  *vlen_out = found ? (span > 0 ? span : 0) : 0;
  *start_out = st.start < 0 ? 0 : (st.start > start_cap ? start_cap : st.start);
}

// narrow rows, a warp a record
__global__ void __launch_bounds__(kRecordWarps * 32)
json_span_warp_kernel(const uint8_t* __restrict__ values, const int32_t* __restrict__ lengths,
                      const uint8_t* __restrict__ needle_g, int klen, int staged,
                      int matchable, long long n, int width, int vec,
                      int32_t* __restrict__ start_out, int32_t* __restrict__ vlen_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* needle = stage_needle(smem + kRecordWarps * kChunk, needle_g, klen, staged);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kRecordWarps + warp;
  if (i >= n) return;
  const int len = lengths[i];
  Cursor cur{values + i * (long long)width, 0, 0, 1, nullptr};
  cur.lim = len < 0 ? 0 : (len < width ? len : width);
  warp_record(cur, vec != 0, len, width, smem + warp * kChunk, needle, klen, matchable != 0, lane,
              start_out + i, vlen_out + i);
}

// stripe rows, a warp a segment
__global__ void __launch_bounds__(kRecordWarps * 32)
json_span_striped_kernel(const uint8_t* __restrict__ sv, const int32_t* __restrict__ owned,
                         const int32_t* __restrict__ first_row, const int32_t* __restrict__ kcount,
                         const int32_t* __restrict__ lengths, const uint8_t* __restrict__ needle_g,
                         int klen, int staged, int matchable, long long n, int s, int step,
                         int vec, int32_t* __restrict__ start_out,
                         int32_t* __restrict__ vlen_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* needle = stage_needle(smem + kRecordWarps * kChunk, needle_g, klen, staged);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kRecordWarps + warp;
  if (i >= n) return;
  const int len = lengths[i];
  const long long r0 = first_row[i];
  Cursor cur{sv + r0 * s, s, step, kcount[i], owned + r0};
  cur.lim = cur.pieces > 0 ? owned[r0] : 0;
  warp_record(cur, vec != 0, len, len, smem + warp * kChunk, needle, klen, matchable != 0, lane,
              start_out + i, vlen_out + i);
}

// A kernel's dynamic shared memory: its own `tile` bytes plus the needle
// where both fit in the device's opt-in maximum a block (*staged = 1); the
// opt-in taken past 48 KB.
template <typename Kernel>
cudaError_t plan_smem(Kernel kernel, size_t tile, int klen, size_t* bytes, int* staged) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *staged = tile + (size_t)klen <= (size_t)optin;
  *bytes = tile + (*staged ? (size_t)klen : 0);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

// `matchable`: 0 where the key holds a backslash or a quote (never found).
extern "C" int fluvio_json_span(const void* values, const void* lengths, const void* needle,
                                int klen, int matchable, long long n, int width, void* start,
                                void* vlen, void* stream) {
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int vec = (width % 16 == 0) && (reinterpret_cast<uintptr_t>(values) % 16 == 0);
    const auto* v = static_cast<const uint8_t*>(values);
    const auto* l = static_cast<const int32_t*>(lengths);
    const auto* nd = static_cast<const uint8_t*>(needle);
    if (width <= kWarpDesignWidth) {
      const long long rows = kThreadWarps * 32;
      size_t smem = 0;
      int staged = 0;
      const cudaError_t err = plan_smem(json_span_kernel, kThreadWarps * 32 * kTileWords * 4 + 256,
                                        klen, &smem, &staged);
      if (err != cudaSuccess) return (int)err;
      json_span_kernel<<<(unsigned)((n + rows - 1) / rows), kThreadWarps * 32, smem, st>>>(
          v, l, nd, klen, staged, n, width, vec, static_cast<int32_t*>(start),
          static_cast<int32_t*>(vlen));
    } else {
      size_t smem = 0;
      int staged = 0;
      const cudaError_t err =
          plan_smem(json_span_warp_kernel, kRecordWarps * kChunk, klen, &smem, &staged);
      if (err != cudaSuccess) return (int)err;
      json_span_warp_kernel<<<(unsigned)((n + kRecordWarps - 1) / kRecordWarps),
                              kRecordWarps * 32, smem, st>>>(
          v, l, nd, klen, staged, matchable, n, width, vec, static_cast<int32_t*>(start),
          static_cast<int32_t*>(vlen));
    }
  }
  return (int)cudaGetLastError();
}

// sv u8[r, s]; owned i32[r]; first_row, k, lengths i32[n] -> start, vlen i32[n].
extern "C" int fluvio_json_span_striped(const void* sv, const void* owned, const void* first_row,
                                        const void* k, const void* lengths, const void* needle,
                                        int klen, int matchable, long long n, int s, int step,
                                        void* start, void* vlen, void* stream) {
  if (n > 0) {
    const int vec = (s % 16 == 0) && (reinterpret_cast<uintptr_t>(sv) % 16 == 0);
    size_t smem = 0;
    int staged = 0;
    const cudaError_t err =
        plan_smem(json_span_striped_kernel, kRecordWarps * kChunk, klen, &smem, &staged);
    if (err != cudaSuccess) return (int)err;
    json_span_striped_kernel<<<(unsigned)((n + kRecordWarps - 1) / kRecordWarps),
                               kRecordWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sv), static_cast<const int32_t*>(owned),
        static_cast<const int32_t*>(first_row), static_cast<const int32_t*>(k),
        static_cast<const int32_t*>(lengths), static_cast<const uint8_t*>(needle), klen, staged,
        matchable, n, s, step, vec, static_cast<int32_t*>(start), static_cast<int32_t*>(vlen));
  }
  return (int)cudaGetLastError();
}
