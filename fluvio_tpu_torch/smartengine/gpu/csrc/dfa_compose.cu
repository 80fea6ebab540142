// Per-row total DFA transition function over a class stream.
//
// Replaces the Pallas kernel `_dfa_compose_kernel` / `dfa_compose_columns_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:850, pl.pallas_call at
// :922). Contract of `kernels.dfa_compose_columns` (kernels.py:188-226):
// cls int32[rows, T] holds one symbol class per column, -1 meaning identity
// (padding, un-owned stripe bytes, bytes outside a JSON field); table_t
// int32[C, S] is the transposed transition table; out[i, s] is the state
// reached from state s after row i's columns. Per column the running vector
// f updates as f[s] = table_t[c][f[s]] when c >= 0 and stays as it is when
// c < 0. A class at or past C reads row C-1, as the XLA path clips it; no
// caller produces one. The plain torch version is `kernels.dfa_compose_columns`.
//
// Bound on the card: bytes. The kernel reads cls once (4 bytes a column)
// and writes 4*S bytes a row; the work is one shared-memory table lookup per
// state per non-identity column. The TPU kernel padded states to 128 lanes
// and rows to blocks of 512 for VMEM and Mosaic; here each row is one group
// of ceil(S/32) warps, one thread per state, and no padding reaches memory.
// A warp loads 32 consecutive classes of its row with one coalesced load and
// hands each to every lane with __shfl_sync, so the class of a column is
// read from device memory once per warp. A chunk of 32 identity columns is
// skipped with one __ballot_sync (the in-span path is almost all identity).
// The table sits in shared memory as uint8 entries when S <= 256 and uint16
// otherwise; the compiler's largest (258 classes x 257 states x 2 bytes =
// 132,612 bytes) needs dynamic shared memory above 48 KB, which the entry
// point requests with cudaFuncSetAttribute before the launch. The time is
// the dependent chain of shared-memory lookups a warp walks along T.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void dfa_compose_kernel(const int32_t* __restrict__ cls,
                                   const int32_t* __restrict__ table_g, int n_states,
                                   int n_classes, long long rows, int t_len,
                                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* table = reinterpret_cast<T*>(smem);
  const int entries = n_states * n_classes;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < entries; k += blockDim.x * blockDim.y) table[k] = (T)table_g[k];
  __syncthreads();

  // blockDim.x is a multiple of 32, so a warp never spans two rows and a
  // whole warp leaves here together
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int s = threadIdx.x;
  const int lane = threadIdx.x & 31;
  int f = s < n_states ? s : 0;  // lanes past S walk state 0 and write nothing
  const int32_t* crow = cls + row * (long long)t_len;
  for (int t0 = 0; t0 < t_len; t0 += 32) {
    const int mine = t0 + lane < t_len ? crow[t0 + lane] : -1;
    if (__ballot_sync(0xffffffffu, mine >= 0) == 0u) continue;
    const int stop = t_len - t0 < 32 ? t_len - t0 : 32;
    for (int k = 0; k < stop; ++k) {
      int c = __shfl_sync(0xffffffffu, mine, k);
      if (c >= 0) {  // uniform across the warp: every lane holds the same c
        c = c < n_classes ? c : n_classes - 1;
        f = table[c * n_states + f];
      }
    }
  }
  if (s < n_states) out[row * n_states + s] = f;
}

template <typename T>
int launch(const void* cls, const void* table_t, int n_states, int n_classes, long long rows,
           int t_len, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)n_states * n_classes * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dfa_compose_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int lanes = (n_states + 31) / 32 * 32;
  const int rows_per_block = lanes >= 256 ? 1 : 256 / lanes;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  dfa_compose_kernel<T><<<(unsigned)blocks, dim3(lanes, rows_per_block), smem, stream>>>(
      static_cast<const int32_t*>(cls), static_cast<const int32_t*>(table_t), n_states,
      n_classes, rows, t_len, static_cast<int32_t*>(out));
  return 0;
}

}  // namespace

// cls int32[rows, t_len], table_t int32[n_classes, n_states] -> out int32[rows, n_states].
extern "C" int fluvio_dfa_compose(const void* cls, const void* table_t, int n_states,
                                  int n_classes, long long rows, int t_len, void* out,
                                  void* stream) {
  if (rows > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rc = n_states <= 256
                       ? launch<uint8_t>(cls, table_t, n_states, n_classes, rows, t_len, out, st)
                       : launch<uint16_t>(cls, table_t, n_states, n_classes, rows, t_len, out, st);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
