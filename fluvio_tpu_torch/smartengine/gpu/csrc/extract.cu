// Span extraction: out[i, j] = values[i, clamp(start[i] + j, 0, W - 1)] for
// j < vlen[i], else 0.
//
// Replaces the Pallas kernel `_extract_kernel` / `extract_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:261, pl.pallas_call at
// :358), which shifts each transposed record up by `start` with a log-step
// barrel shift. The semantics here are the JAX package's gather form
// (`kernels.extract_span`, kernels.py:302-315); the plain torch version is
// `kernels.extract_span`. The two JAX forms agree on every span a JSON span
// kernel emits (start + vlen <= length).
//
// Bound on the card: bytes (write N*W; read the live bytes and 8 bytes of
// (start, vlen) a row). A thread an output byte spends its time on
// arithmetic instead: a 64-bit division for its row, two index loads and a
// one-byte store for every byte, though most bytes of a row lie past the
// span and are zeros. Here a thread writes one 16-byte segment of a row.
// Row and segment come from the launch geometry (threadIdx.x the segment,
// threadIdx.y and blockIdx.x the row), so no thread divides; a thread reads
// its row's start and vlen once.
//
// - A segment at or past vlen is 16 zero bytes, stored at once, and reads
//   no input.
// - Where W % 16 == 0 and `values` is 16-byte aligned (every row then is),
//   a live segment whose source window [start + j0, start + j0 + 16) lies in
//   the row reads it as four or five aligned 4-byte words, shifts them into
//   place by (start + j0) % 4 with funnel shifts, zeroes the bytes from
//   vlen on and stores 16 bytes. The clamp never acts inside such a window.
// - Every other segment takes the byte path, which is the plain version's
//   rule byte for byte: a window that passes the row's end (the clamp
//   repeats byte W - 1), start < 0 (the clamp repeats byte 0), and every
//   segment of a width that is no multiple of 16 (there rows are not
//   16-byte aligned), which also stores byte by byte.
// tests/test_torch_encode_extract_redesign.py holds the plain version to the
// JAX package's gather on random spans with overruns and negative starts at
// widths 1 to 1,000; chip_smoke.py holds this kernel to the plain version
// on the same kind of spans.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 16;
constexpr int kThreads = 256;

// the plain version's byte j of a row (j < width)
__device__ __forceinline__ uint32_t span_byte(const uint8_t* row, int st, int live, int width,
                                              int j) {
  if (j >= live) return 0;
  long long p = (long long)st + j;
  p = p < 0 ? 0 : (p > width - 1 ? width - 1 : p);
  return row[p];
}

__global__ void __launch_bounds__(kThreads)
extract_kernel(const uint8_t* __restrict__ values, const int32_t* __restrict__ start,
               const int32_t* __restrict__ vlen, long long n, int width, int segs, int vec,
               uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const int st = start[i];
  const int vl = vlen[i];
  const int live = vl < 0 ? 0 : (vl < width ? vl : width);
  const uint8_t* row = values + i * width;
  uint8_t* dst = out + i * width;
  for (int s = threadIdx.x; s < segs; s += blockDim.x) {
    const int j0 = s * kSeg;
    if (!vec) {
      const int stop = width - j0 < kSeg ? width - j0 : kSeg;
      for (int b = 0; b < stop; ++b) dst[j0 + b] = (uint8_t)span_byte(row, st, live, width, j0 + b);
      continue;
    }
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (j0 < live) {
      const long long a = (long long)st + j0;
      if (st >= 0 && a + kSeg <= width) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (a & ~3LL));
        const int sh = (int)(a & 3) * 8;
        const uint32_t x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3];
        const uint32_t x4 = sh ? w[4] : 0u;  // inside the row: W % 4 == 0
        o[0] = __funnelshift_r(x0, x1, sh);
        o[1] = __funnelshift_r(x1, x2, sh);
        o[2] = __funnelshift_r(x2, x3, sh);
        o[3] = __funnelshift_r(x3, x4, sh);
        const int keep = live - j0;  // >= 1
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = keep - 4 * k;
          o[k] &= c >= 4 ? 0xFFFFFFFFu : (c <= 0 ? 0u : (1u << (8 * c)) - 1u);
        }
      } else {
#pragma unroll
        for (int b = 0; b < kSeg; ++b) o[b >> 2] |= span_byte(row, st, live, width, j0 + b)
                                                    << (8 * (b & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst + j0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

extern "C" int fluvio_extract(const void* values, const void* start, const void* vlen,
                              long long n, int width, void* out, void* stream) {
  if (n > 0 && width > 0) {
    const int segs = (width + kSeg - 1) / kSeg;
    const int vec = width % kSeg == 0 && reinterpret_cast<uintptr_t>(values) % kSeg == 0 &&
                    reinterpret_cast<uintptr_t>(out) % kSeg == 0;
    // threads along x cover a row's segments (a power of two up to the
    // block), the rest of the block further rows
    int tx = 1;
    while (tx < segs && tx < kThreads) tx <<= 1;
    const dim3 block(tx, kThreads / tx);
    const long long blocks = (n + block.y - 1) / block.y;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    extract_kernel<<<(unsigned)blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(values), static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(vlen), n, width, segs, vec, static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}
