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
// Design: a thread a segment, walking its rows' owned bytes in order, four
// bytes a load (rows start on 4-byte boundaries: the stripe width is a
// multiple of 4). 32 threads a block, so a batch of n records spreads over
// n / 32 SMs. A simple walk that is right; the sequential chain per record
// is what bounds it, and a warp-a-segment design (the state maps composed
// across lanes, as `json_span.cu`'s warp walk does) is the way to make it
// fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ bool is_ws(uint32_t c) { return (c >= 9u && c <= 13u) || c == 32u; }

struct Segment {
  const uint8_t* sv;
  const int32_t* owned;
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

__global__ void __launch_bounds__(kThreads)
    json_array_striped_kernel(const uint8_t* __restrict__ sv, const int32_t* __restrict__ owned,
                              const int32_t* __restrict__ first_row,
                              const int32_t* __restrict__ k_of, long long n, int s, int step,
                              uint8_t* __restrict__ flag, int32_t* __restrict__ start,
                              int32_t* __restrict__ elen, uint8_t* __restrict__ err) {
  const long long seg = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (seg >= n) return;
  const int k = k_of[seg];
  if (k <= 0) {
    err[seg] = 0;
    return;
  }
  const Segment g{sv, owned, (long long)first_row[seg], k, s, step};

  // the outer first and last non-whitespace bytes
  long long fa = -1, fb = -1;
  for (int j = 0; j < k && fa < 0; ++j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    for (int c = 0; c < own; ++c) {
      if (!is_ws(row[c])) {
        fa = (long long)j * step + c;
        break;
      }
    }
  }
  for (int j = k - 1; j >= 0 && fb < 0; --j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    for (int c = own - 1; c >= 0; --c) {
      if (!is_ws(row[c])) {
        fb = (long long)j * step + c;
        break;
      }
    }
  }
  const bool ok = fa >= 0 && fb > fa && sv[g.flat(fa)] == '[' && sv[g.flat(fb)] == ']';
  err[seg] = ok ? 0 : 1;
  if (!ok) return;

  bool in_str = false, esc = false;
  long long depth = 0;
  long long fnw = -1, lnw = -1;  // the element's first and last non-whitespace bytes
  uint32_t first_b = 0, last_b = 0;
  long long j = (fa + 1) / step;
  if (j > k - 1) j = k - 1;
  for (; j < k; ++j) {
    const uint8_t* row = sv + (g.first + j) * s;
    const int own = owned[g.first + j];
    const long long base = j * (long long)step;
    const int c0 = (fa + 1 > base) ? (int)(fa + 1 - base) : 0;
    for (int c4 = c0 & ~3; c4 < own; c4 += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c4);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = c4 + t;
        if (c < c0 || c >= own) continue;
        const long long p = base + c;
        const uint32_t b = (w >> (8 * t)) & 0xFFu;
        bool boundary = p == fb;
        if (!boundary) {
          if (in_str) {
            if (esc) {
              esc = false;
            } else if (b == '\\') {
              esc = true;
            } else if (b == '"') {
              in_str = false;
            }
          } else if (b == '"') {
            in_str = true;
          } else if (b == '[' || b == '{') {
            ++depth;
          } else if (b == ']' || b == '}') {
            --depth;
          } else if (b == ',' && depth == 0) {
            boundary = true;
          }
          if (!boundary && !is_ws(b)) {
            if (fnw < 0) {
              fnw = p;
              first_b = b;
            }
            lnw = p;
            last_b = b;
          }
        }
        if (boundary) {
          if (fnw >= 0) {
            const int quoted = (first_b == '"' && last_b == '"' && lnw > fnw) ? 1 : 0;
            const long long st = fnw + quoted;
            const long long ln = lnw - quoted - st + 1;
            if (ln > 0) {
              const long long at = g.flat(st);
              flag[at] = 1;
              start[at] = (int32_t)st;
              elen[at] = (int32_t)ln;
            }
          }
          fnw = lnw = -1;
          if (p == fb) return;
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
    json_array_striped_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sv), static_cast<const int32_t*>(owned),
        static_cast<const int32_t*>(first_row), static_cast<const int32_t*>(k), n, s, step,
        static_cast<uint8_t*>(flag), static_cast<int32_t*>(start), static_cast<int32_t*>(elen),
        static_cast<uint8_t*>(err));
  }
  return (int)cudaGetLastError();
}
