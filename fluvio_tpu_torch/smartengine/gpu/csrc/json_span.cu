// JSON top-level field span: one thread per record.
//
// Replaces the Pallas kernel `_json_scan_kernel` / `json_get_span_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:100, pl.pallas_call at
// :316). Semantics are the JAX package's sequential machine
// (`kernels.json_step` / `json_span_finalize`, kernels.py:370-528): find
// "key" at brace depth 1, skip ':' and whitespace, then a string value runs
// to its closing quote and a raw value to the next top-level , ] or },
// trimmed of space, tab, CR and LF (not \x0b or \x0c); an unterminated value
// closes at the end of the record. The plain torch version is
// `kernels.json_get_span`; chip_smoke.py holds this kernel to it exactly.
//
// Bound on the card: bytes. The kernel reads each input byte once (N*W + 4N)
// and writes 8N; the per-byte automaton is ~40 integer operations, far below
// the card's integer rate. The TPU kernel transposed the batch to (W, N) so
// records rode the lanes; here each thread walks its own row instead, with
// 16-byte vector loads when rows are 16-byte aligned, and stops at the end
// of the record or when the field is found. Loads are still uncoalesced
// (neighbouring threads read rows W bytes apart), so the likely next step is
// warp-cooperative 16-byte loads staged through shared memory, one tile of
// rows per warp, with each thread then scanning its row from shared memory.
//
// Second entry point, `fluvio_json_span_striped`: the same machine over the
// striped wide-record layout, one thread per segment (record). It replaces
// no Pallas kernel: the JAX package runs it as an XLA lax.scan
// (`stripes.striped_json_span`, fluvio_tpu/smartengine/tpu/stripes.py:263),
// kmax x s byte columns in turn, which in eager torch would be ~90k steps of
// some 60 launches each. The thread walks the OWNED bytes of its segment's
// stripe rows first_row .. first_row+k-1 in order (the overlap tail of a
// non-last row belongs to the next row), at record-absolute positions
// kk*step + j, so the carry crosses stripe joints exactly, and stops at
// P_DONE. The start clips to the record length. Plain torch version:
// `kernels.striped_json_span`. Bound: bytes, as above; with one thread per
// record the card is mostly idle unless the field sits late in the record.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P_SCAN = 0, P_COLON = 1, P_WS = 2, P_STR = 3, P_RAW = 4, P_DONE = 5;

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

  // One byte through the machine; every branch mirrors a `where` of
  // kernels.json_step, in the same order.
  __device__ __forceinline__ void step(int c, int t, const uint8_t* needle, int klen) {
    const bool is_ws = (c == 32) | (c == 9) | (c == 13) | (c == 10);
    const bool is_quote = c == 0x22;
    const bool is_bslash = c == 0x5C;

    // phase COLON: ws -> stay; ':' -> WS; anything else aborts and is
    // reprocessed by the general scan below
    const bool colon_here = (phase == P_COLON) & (c == 0x3A);
    const bool colon_abort = (phase == P_COLON) & !is_ws & (c != 0x3A);
    const bool g = (phase == P_SCAN) | colon_abort;

    // general scan inside a string: progressive needle match
    const bool gs = g & in_str;
    const bool s_esc_consume = gs & esc;
    const bool s_set_esc = gs & !esc & is_bslash;
    const bool s_close = gs & !esc & is_quote;
    const bool s_key_done = s_close & (kmatch == klen - 1);
    const bool s_ordinary = gs & !esc & !is_bslash & !is_quote;
    const int kc = kmatch < 0 ? 0 : (kmatch > klen - 1 ? klen - 1 : kmatch);
    const int k_next =
        ((kmatch > 0) & (kmatch < klen - 1) & (c == needle[kc])) ? kmatch + 1 : 0;

    // general scan outside a string
    const bool go = g & !in_str;
    const bool o_open = go & is_quote;
    const bool o_up = go & (c == 0x7B);
    const bool o_dn = go & (c == 0x7D);

    const bool n_in_str = s_close ? false : (o_open ? true : in_str);
    const bool n_esc = gs ? s_set_esc : esc;
    const int n_depth = depth + (o_up ? 1 : 0) - (o_dn ? 1 : 0);
    int n_kmatch = s_ordinary ? k_next : kmatch;
    if (s_set_esc | s_esc_consume | s_close) n_kmatch = 0;
    if (o_open) n_kmatch = (depth == 1) ? 1 : 0;

    // phase WS (after the colon): classify the value start
    const bool w = phase == P_WS;
    const bool w_go = w & !is_ws;
    const bool w_str = w_go & is_quote;
    const bool is_closer = (c == 0x5D) | (c == 0x7D) | (c == 0x2C);
    const bool w_empty = w_go & !is_quote & is_closer;
    const bool w_raw = w_go & !is_quote & !is_closer;
    const bool w_raw_open = w_raw & ((c == 0x5B) | (c == 0x7B));

    // phase STR (string value)
    const bool s3 = phase == P_STR;
    const bool s3_set_esc = s3 & !vesc & is_bslash;
    const bool s3_close = s3 & !vesc & is_quote;

    // phase RAW (scalar / nested value)
    const bool s4 = phase == P_RAW;
    const bool r_open = s4 & ((c == 0x5B) | (c == 0x7B));
    const bool r_close = s4 & ((c == 0x5D) | (c == 0x7D));
    const bool r_comma = s4 & (c == 0x2C);
    const bool r_end = (r_close | r_comma) & (d2 == 0);
    const bool r_dec = r_close & (d2 > 0);

    int n_phase = phase;
    if (s_key_done) n_phase = P_COLON;
    if (colon_here) n_phase = P_WS;
    if (colon_abort) n_phase = P_SCAN;
    if (w_str) n_phase = P_STR;
    if (w_empty) n_phase = P_DONE;
    if (w_raw) n_phase = P_RAW;
    if (s3_close) n_phase = P_DONE;
    if (r_end) n_phase = P_DONE;

    vesc = s3 ? s3_set_esc : vesc;
    d2 = d2 + (w_raw_open ? 1 : 0) + (r_open ? 1 : 0) - (r_dec ? 1 : 0);
    start = w_str ? t + 1 : ((w_raw | w_empty) ? t : start);
    end = s3_close ? t : (r_end ? lastnw + 1 : (w_empty ? t : end));
    lastnw = ((w_raw & !is_ws) | (s4 & !r_end & !is_ws)) ? t : lastnw;
    phase = n_phase;
    kmatch = n_kmatch;
    in_str = n_in_str;
    esc = n_esc;
    depth = n_depth;
  }
};

__global__ void json_span_kernel(const uint8_t* __restrict__ values,
                                 const int32_t* __restrict__ lengths,
                                 const uint8_t* __restrict__ needle_g, int klen,
                                 long long n, int width, int vec,
                                 int32_t* __restrict__ start_out,
                                 int32_t* __restrict__ vlen_out) {
  extern __shared__ uint8_t needle[];
  for (int k = threadIdx.x; k < klen; k += blockDim.x) needle[k] = needle_g[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int len = lengths[i];
  const int lim = len < 0 ? 0 : (len < width ? len : width);
  const uint8_t* row = values + i * (long long)width;
  JsonMachine m;
  if (vec) {
    for (int j0 = 0; j0 < lim && m.phase != P_DONE; j0 += 16) {
      const uint4 chunk = *reinterpret_cast<const uint4*>(row + j0);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&chunk);
      const int stop = lim - j0 < 16 ? lim - j0 : 16;
      for (int k = 0; k < stop && m.phase != P_DONE; ++k) m.step(b[k], j0 + k, needle, klen);
    }
  } else {
    for (int j = 0; j < lim && m.phase != P_DONE; ++j) m.step(row[j], j, needle, klen);
  }
  // end of record: unterminated values run to the end
  int end = m.end;
  if (m.phase == P_STR) end = len;
  if (m.phase == P_RAW) end = m.lastnw + 1;
  const bool found = (m.phase == P_DONE) | (m.phase == P_STR) | (m.phase == P_RAW);
  const int span = end - m.start;
  vlen_out[i] = found ? (span > 0 ? span : 0) : 0;
  start_out[i] = m.start < 0 ? 0 : (m.start > width ? width : m.start);
}

__global__ void json_span_striped_kernel(const uint8_t* __restrict__ sv,
                                         const int32_t* __restrict__ owned,
                                         const int32_t* __restrict__ first_row,
                                         const int32_t* __restrict__ kcount,
                                         const int32_t* __restrict__ lengths,
                                         const uint8_t* __restrict__ needle_g, int klen,
                                         long long n, int s, int step, int vec,
                                         int32_t* __restrict__ start_out,
                                         int32_t* __restrict__ vlen_out) {
  extern __shared__ uint8_t needle[];
  for (int k = threadIdx.x; k < klen; k += blockDim.x) needle[k] = needle_g[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int len = lengths[i];
  const int kseg = kcount[i];
  JsonMachine m;
  for (int kk = 0; kk < kseg && m.phase != P_DONE; ++kk) {
    const long long r = (long long)first_row[i] + kk;
    const int lim = owned[r];
    const uint8_t* row = sv + r * (long long)s;
    const int base = kk * step;
    if (vec) {
      for (int j0 = 0; j0 < lim && m.phase != P_DONE; j0 += 16) {
        const uint4 chunk = *reinterpret_cast<const uint4*>(row + j0);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&chunk);
        const int stop = lim - j0 < 16 ? lim - j0 : 16;
        for (int k = 0; k < stop && m.phase != P_DONE; ++k)
          m.step(b[k], base + j0 + k, needle, klen);
      }
    } else {
      for (int j = 0; j < lim && m.phase != P_DONE; ++j) m.step(row[j], base + j, needle, klen);
    }
  }
  int end = m.end;
  if (m.phase == P_STR) end = len;
  if (m.phase == P_RAW) end = m.lastnw + 1;
  const bool found = (m.phase == P_DONE) | (m.phase == P_STR) | (m.phase == P_RAW);
  const int span = end - m.start;
  vlen_out[i] = found ? (span > 0 ? span : 0) : 0;
  start_out[i] = m.start < 0 ? 0 : (m.start > len ? len : m.start);
}

}  // namespace

extern "C" int fluvio_json_span(const void* values, const void* lengths, const void* needle,
                                int klen, long long n, int width, void* start, void* vlen,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    const int vec = (width % 16 == 0) && (reinterpret_cast<uintptr_t>(values) % 16 == 0);
    json_span_kernel<<<(unsigned)blocks, threads, klen, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(values), static_cast<const int32_t*>(lengths),
        static_cast<const uint8_t*>(needle), klen, n, width, vec,
        static_cast<int32_t*>(start), static_cast<int32_t*>(vlen));
  }
  return (int)cudaGetLastError();
}

// sv u8[r, s]; owned i32[r]; first_row, k, lengths i32[n] -> start, vlen i32[n].
extern "C" int fluvio_json_span_striped(const void* sv, const void* owned, const void* first_row,
                                        const void* k, const void* lengths, const void* needle,
                                        int klen, long long n, int s, int step, void* start,
                                        void* vlen, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    const int vec = (s % 16 == 0) && (reinterpret_cast<uintptr_t>(sv) % 16 == 0);
    json_span_striped_kernel<<<(unsigned)blocks, threads, klen,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sv), static_cast<const int32_t*>(owned),
        static_cast<const int32_t*>(first_row), static_cast<const int32_t*>(k),
        static_cast<const int32_t*>(lengths), static_cast<const uint8_t*>(needle), klen, n, s,
        step, vec, static_cast<int32_t*>(start), static_cast<int32_t*>(vlen));
  }
  return (int)cudaGetLastError();
}
