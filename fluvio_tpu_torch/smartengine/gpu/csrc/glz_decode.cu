// glz decode resolve: out[i] = base[f^8(i)], where f follows each byte's
// gather source midx inside its own chunk.
//
// Replaces the Pallas kernel `_glz_resolve_kernel` / `glz_decode_pallas`
// (fluvio_tpu/smartengine/tpu/pallas_kernels.py:434 and :462,
// pl.pallas_call at :494). That kernel loads one chunk of the byte plan
// (`glz.byte_plan_device`: `base` = literal bytes in place, `midx` = each
// byte's source, literal and pad bytes pointing at themselves) into VMEM,
// squares the chunk-local index three times (idx = idx[idx]) and gathers
// `base` once. Three squarings apply midx 2^3 = 8 times, and a glz stream's
// match chains are at most MAX_DEPTH = 6 long, so every byte lands on its
// literal root. The plain torch version is `kernels.glz_resolve`.
//
// On the card there is no VMEM block to keep the rounds in, and no need for
// one: a byte's chain is private to it. One thread per output byte follows
// its own chain for the same 8 steps, in global indices, and reads `base`
// once; it stops early at a fixpoint (a literal byte), where every further
// step would stay put. Each step's source is clipped into the byte's chunk,
// as the plain version clips the chunk-local index; `compress_link` streams
// never leave their chunk, so the clip never fires on them. A step onto a
// pad byte of the ragged last chunk (index >= n) stops there and yields 0,
// as the plain version's self-referencing zero pad does.
//
// Bound on the card: bytes. Each output byte needs its midx (4 B), one base
// byte and its store: 6n bytes. The first midx load and the store are
// coalesced; the chain's further loads fall near the byte's source (a match
// copies a nearby run), so they mostly hit L2.

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
