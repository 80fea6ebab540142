// Per-record DFA verdict: a persistent grid, a thread a record.
//
// Replaces the Pallas kernel `_dfa_scan_kernel` / `dfa_match_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:651, pl.pallas_call at
// :765). Semantics are `kernels.dfa_match` (kernels.py:32-62): column j
// feeds byte_class[byte] while j < length, the EOS class at j == length
// and the PAD class after it, then one trailing symbol (EOS when
// length == W, else PAD); a negative length reads PAD throughout. The
// plain torch version is `kernels.dfa_match`.
//
// Bound on the card: bytes (each record's live bytes, its length and its
// verdict), and below them the dependent chain of shared-memory lookups a
// record's bytes make. The old kernel walked all W columns and the
// trailing symbol (65 dependent steps at W = 64 for names of 7-15 bytes),
// read whole rows, paid two dependent shared-memory loads and a multiply a
// byte, and launched a block per 256 records, each copying the tables into
// shared memory (4,096 copies at 1 M records; 132 KB each for the largest
// table, one 256-thread block an SM). This design:
//
// - walks min(length, W) bytes and loads only the 16-byte chunks that hold
//   them. The host (`cuda_kernels.scan_tables`) checks that PAD never
//   changes whether a state accepts (`accept[table[s, pad]] == accept[s]`,
//   which the compiler guarantees: its PAD column is `s` for accepting
//   states and dead otherwise). Then the verdict is `eos_accept[s]` for
//   0 <= length <= W, `accept[s]` for length > W and `accept[start]` for a
//   negative length, with s the state after the walked bytes. A table that
//   fails the check (only a hand-built one can) takes the `kTail` instance,
//   which walks the EOS/PAD tail as the plain version does;
// - steps a byte with one add and one dependent shared-memory load: the
//   folded table `next[b][s] = table[s, byte_class[b]]`, column-major, each
//   entry the next state's byte offset in a column, so the state is the
//   load's offset as it comes (`b * stride` is off the chain). A column
//   takes 13 four-byte words modulo 32 (padded), so the columns of
//   neighbouring bytes start 13 banks apart: lanes reading different bytes
//   in the same few states meet in few banks. Steps past a record's walk
//   read a valid entry and keep the state (a select, no branch);
// - runs a persistent grid: SM count x the blocks an SM holds at the
//   table's shared memory, the block size (256 to 1,024 threads) that keeps
//   the most threads resident (larger on a tie: fewer copies). Each block
//   copies the table image (one blob, laid out on the host as shared memory
//   holds it) once with 16-byte loads and walks records grid-stride. The
//   folded 257-state table (144 KB with its padding) runs as one
//   1,024-thread block an SM.
//
// Rows that are not 16-byte aligned (or widths off the 16-byte grid) read
// the same chunks byte by byte. State offsets are uint8 up to 256 states
// and uint16 for 257. No tensor cores or TMA: a byte walk is a serial chain
// of dependent lookups. Designs measured and dropped (PERF.md): a
// lane that stops at a chunk starting in a settled state, a flat loop
// that moves a lane to its next record at once with the next chunk
// prefetched, a row-major fold, the packed table's two loads a byte (the
// class form) and a grid of a block per 1,024 records.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // bytes a vector load brings
// per-state flag bits (the host's `scan_tables` flags)
constexpr uint8_t kAccept = 1, kEosAccept = 2;

// bytes j0 .. j0+15 of a row, those at or past `walk` as 0
__device__ __forceinline__ uint4 load_chunk(const uint8_t* row, int j0, int walk, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + j0));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    if (j0 + k < walk) w[k >> 2] |= (uint32_t)__ldg(row + j0 + k) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The table image in shared memory (offsets in bytes, multiples of 16):
// at 0 the folded next-state table column-major, a byte's column every
// `stride` bytes, each entry the next state's byte offset in a column
// (state * sizeof(T)); uint8 flags[S] at flags_off; for kTail, T pairs
// (EOS next, PAD next) per state, as offsets, at tail_off.
template <typename T, bool kTail>
__global__ void __launch_bounds__(1024)
dfa_scan_kernel(const uint8_t* __restrict__ values, const int32_t* __restrict__ lengths,
                const uint4* __restrict__ blob, int blob_bytes, int stride, int flags_off,
                int tail_off, int start, long long n, int width, int vec,
                uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  for (int k = threadIdx.x; k < blob_bytes / 16; k += blockDim.x) smem4[k] = blob[k];
  __syncthreads();
  constexpr int kShift = sizeof(T) == 2 ? 1 : 0;  // state id -> byte offset
  const unsigned char* smem = reinterpret_cast<const unsigned char*>(smem4);
  const uint8_t* flags = smem + flags_off;

  const long long grid_stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += grid_stride) {
    const int len = __ldg(lengths + i);
    const int walk = min(max(len, 0), width);
    const uint8_t* row = values + i * (long long)width;
    uint32_t s = (uint32_t)start << kShift;
    for (int j0 = 0; j0 < walk; j0 += kChunk) {
      const uint4 c = load_chunk(row, j0, walk, vec);
      const uint32_t w[4] = {c.x, c.y, c.z, c.w};
      const int rem = walk - j0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        // a step past the walk reads a valid entry and keeps the state:
        // no branch on the dependent chain
        const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
        const uint32_t t = *reinterpret_cast<const T*>(smem + b * (uint32_t)stride + s);
        s = k < rem ? t : s;
      }
    }
    bool accept;
    if (kTail) {
      const T* tail = reinterpret_cast<const T*>(smem + tail_off);
      int pads = 1;  // len > W: the trailing PAD
      if (len < 0) {
        pads = width + 1;
      } else if (len <= width) {
        s = tail[2 * (s >> kShift)];
        pads = width - len;
      }
      for (int k = 0; k < pads; ++k) s = tail[2 * (s >> kShift) + 1];
      accept = flags[s >> kShift] & kAccept;
    } else {
      accept = flags[s >> kShift] & ((len < 0 || len > width) ? kAccept : kEosAccept);
    }
    out[i] = accept ? 1 : 0;
  }
}

template <typename T, bool kTail>
int launch(const void* values, const void* lengths, const void* blob, int blob_bytes,
           int stride, int flags_off, int tail_off, int start, long long n, int width,
           void* out, cudaStream_t stream) {
  const auto kernel = dfa_scan_kernel<T, kTail>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && blob_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, blob_bytes);
  if (e != cudaSuccess) return (int)e;
  // the block size that keeps the most threads of an SM resident
  int threads = 0, per_sm = 0;
  for (int t = 256; t <= 1024; t *= 2) {
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, t, blob_bytes);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 0 && blocks * t >= per_sm * threads) threads = t, per_sm = blocks;
  }
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long needed = (n + threads - 1) / threads;
  const long long grid = needed < (long long)sms * per_sm ? needed : (long long)sms * per_sm;
  const int vec = (width % kChunk == 0) && (reinterpret_cast<uintptr_t>(values) % 16 == 0);
  kernel<<<(unsigned)grid, threads, blob_bytes, stream>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(lengths),
      static_cast<const uint4*>(blob), blob_bytes, stride, flags_off, tail_off, start, n, width,
      vec, static_cast<uint8_t*>(out));
  return 0;
}

template <typename T>
int launch_form(int tail, const void* values, const void* lengths, const void* blob,
                int blob_bytes, int stride, int flags_off, int tail_off, int start,
                long long n, int width, void* out, cudaStream_t s) {
  return tail ? launch<T, true>(values, lengths, blob, blob_bytes, stride, flags_off, tail_off,
                                start, n, width, out, s)
              : launch<T, false>(values, lengths, blob, blob_bytes, stride, flags_off, tail_off,
                                 start, n, width, out, s);
}

}  // namespace

// blob: the table image (`cuda_kernels._scan_image`), blob_bytes a
// multiple of 16; entry_bytes: 1 (uint8 state ids) or 2 (uint16); tail:
// walk the EOS/PAD tail (a table whose PAD column changes acceptance).
extern "C" int fluvio_dfa_scan(const void* values, const void* lengths, const void* blob,
                               int blob_bytes, int entry_bytes, int tail, int stride,
                               int flags_off, int tail_off, int start, long long n, int width,
                               void* out, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rc =
        entry_bytes == 1
            ? launch_form<uint8_t>(tail, values, lengths, blob, blob_bytes, stride, flags_off,
                                   tail_off, start, n, width, out, s)
            : launch_form<uint16_t>(tail, values, lengths, blob, blob_bytes, stride, flags_off,
                                    tail_off, start, n, width, out, s);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
