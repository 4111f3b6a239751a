// Kernel 1: the 128-bit row fingerprint.
//
// Replaces the Pallas kernel dslabs_tpu/tpu/kernels.py (_kernel /
// _pallas_call, entry fingerprint_rows).  Per row of L int32 lanes, each
// lane x at position l is mixed with the add-shift-xor mixer for seeds 1
// and 2 (pos = l + seed * 0x1000193): h = mix32(x, pos), and the lanes
// are summed twice with uint32 wrap, once over h and once over
// mix32(h, pos + 0x27D4EB2F).  Output row = (a_hi, a_lo, b_hi, b_lo).
// The plain PyTorch version is engine.row_fingerprints.
//
// Design: one warp per row.  L is a few hundred to about a thousand lanes
// (842 on the flagship Paxos twin, 167 on lab1), so each thread of the
// warp strides over at most ~30 lanes, neighbouring threads read
// neighbouring words (coalesced 128-byte rows of loads), and the four
// partial sums are reduced with warp shuffles alone: no shared memory and
// no block barrier.  A block per row would leave most threads idle on
// narrow rows.  uint32 wrapping addition is associative and commutative,
// so the result is bit-exact whatever the order of the reduction.
//
// Bound: per lane the kernel reads 4 bytes and does four mixes and four
// adds.  Of each mix's 10 instructions, 7 (xor, 3 shifts, 3 xors) need
// the int32 logic/shift/add units (64 lanes per SM per clock); its 3
// shift-adds x + (x << k) are multiplies by 1 + 2^k and issue as IMAD on
// the FMA pipe.  That is 32 such operations per 4-byte lane, 8 per byte,
// against HBM's ~0.2 bytes per int32 operation on this card: the int32
// units bound it rather than HBM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // rows per 256-thread block
constexpr uint32_t SEED_STEP = 0x1000193u;
constexpr uint32_t POS2 = 0x27D4EB2Fu;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed * 0x9E3779B9u;
  x += x << 10;
  x ^= x >> 6;
  x += x << 3;
  x ^= x >> 11;
  x += x << 15;
  x ^= x >> 7;
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
fingerprint_rows_kernel(const uint32_t* __restrict__ in,
                        uint4* __restrict__ out, long long rows, int L) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;              // whole warp leaves together
  const uint32_t* r = in + row * (long long)L;
  uint32_t a_lo = 0, a_hi = 0, b_lo = 0, b_hi = 0;
  for (int l = lane; l < L; l += 32) {
    const uint32_t x = __ldg(r + l);
    const uint32_t pa = (uint32_t)l + SEED_STEP;
    const uint32_t pb = (uint32_t)l + 2u * SEED_STEP;
    const uint32_t ha = mix32(x, pa);
    const uint32_t hb = mix32(x, pb);
    a_lo += ha;
    a_hi += mix32(ha, pa + POS2);
    b_lo += hb;
    b_hi += mix32(hb, pb + POS2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a_lo += __shfl_xor_sync(0xffffffffu, a_lo, o);
    a_hi += __shfl_xor_sync(0xffffffffu, a_hi, o);
    b_lo += __shfl_xor_sync(0xffffffffu, b_lo, o);
    b_hi += __shfl_xor_sync(0xffffffffu, b_hi, o);
  }
  if (lane == 0) out[row] = make_uint4(a_hi, a_lo, b_hi, b_lo);
}

}  // namespace

// in: [rows, L] int32 (read as uint32), out: [rows, 4] uint32.  Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int dsl_fingerprint_rows(const void* in, void* out,
                                    long long rows, int L, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    fingerprint_rows_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint4*)out, rows, L);
  }
  return (int)cudaGetLastError();
}
