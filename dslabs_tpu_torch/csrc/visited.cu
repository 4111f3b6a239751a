// Kernel 2: membership + insert of a 128-bit key batch in the visited
// table.
//
// Replaces the Pallas kernel dslabs_tpu/tpu/visited.py:pallas_insert
// (body insert_jnp over _probe_iter).  The plain PyTorch version is
// visited.insert_plain; the two agree bit for bit on the table rows
// [0, V), on `inserted` and on `unresolved`.
//
// Table: [V + 1, 4] uint32, V a power of two, viewed as V/8 buckets of 8
// slots (one aligned 128-byte line).  EMPTY = all-MAX.  The trailing row
// is never written.  Home bucket = key[2] & (V/8 - 1); the step past a
// full bucket is key[1] | 1.  The all-MAX key of a valid row is read as
// lane 3 = MAX - 1 (sanitised on the fly).
//
// Semantics, round by round as in _probe_iter: every unresolved key reads
// its whole bucket line and computes eq / has_empty / first_empty from
// the table as it stood at the start of the round (the reserve kernel
// reads, the claim kernel writes).  A key that wants a slot does an
// atomicMin of its batch index into res[bucket & (RT - 1)]; the minimum
// wins and writes its key to the first empty slot; losers stay on the
// bucket; keys of a full bucket move on by their step.  Phases:
//   full: at least one round, then on while more than
//         T = max(N / 8, min(256, N)) keys are unresolved, at most
//         max_iters rounds;
//   tail: the lowest-index min(U, T) unresolved keys get up to max_iters
//         more rounds; any others stay unresolved.
// Ranking tail keys by their batch index is the same tie-break order as
// the reference's rank inside the compacted tail, so winners agree.
//
// Structure: a fixed schedule of per-round launches (reserve, claim) for
// up to max_iters full rounds and max_iters tail rounds, all enqueued by
// one C call.  Each launch reads the counters the previous rounds left in
// `ctl` and exits at once when its round is not active, so the host never
// synchronises inside an insert.  The reservation cells hold 64-bit
// values (~round << 32 | index): a later round always beats a stale
// entry, so `res` is filled once per call instead of once per round.
//
// Bound: memory.  Per valid key a round reads 16 B of key and one 128 B
// bucket line; an insert writes 16 B; every key writes its two flags.
// This first version is simple and right; TMA loads and warp-specialised
// probing are later work.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKT = 8;
constexpr uint8_t RESOLVED = 1, INSERTED = 2, EXCLUDED = 4;
constexpr int THREADS = 256;
constexpr int SELECT_THREADS = 1024;

// ctl layout (int32, zeroed by the caller):
//   ctl[0]                  valid keys (unresolved before full round 0)
//   ctl[1]                  keys admitted to the tail phase
//   ctl[2 + r]              keys left unresolved by full round r
//   ctl[2 + max_iters + t]  tail keys left unresolved by tail round t

__device__ __forceinline__ uint4 load_key(const uint4* __restrict__ keys,
                                          const uint8_t* __restrict__ valid,
                                          long long i) {
  uint4 k = keys[i];
  if (valid[i] && (k.x & k.y & k.z & k.w) == 0xffffffffu) k.w = 0xfffffffeu;
  return k;
}

__device__ __forceinline__ bool round_active(const int* ctl, int phase,
                                             int r, int T, int max_iters) {
  if (phase == 0) return r == 0 ? ctl[0] > 0 : ctl[2 + r - 1] > T;
  return r == 0 ? ctl[1] > 0 : ctl[2 + max_iters + r - 1] > 0;
}

__device__ __forceinline__ unsigned long long round_tag(int phase, int r,
                                                        int max_iters) {
  return (unsigned long long)(0xffffffffu -
                              (unsigned)(phase * max_iters + r)) << 32;
}

__global__ void init_kernel(const uint4* __restrict__ keys,
                            const uint8_t* __restrict__ valid,
                            int* __restrict__ bkt,
                            uint8_t* __restrict__ state, int* ctl,
                            long long n, unsigned vb_mask) {
  int cnt = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const bool v = valid[i] != 0;
    const uint4 k = load_key(keys, valid, i);
    bkt[i] = (int)(k.z & vb_mask);
    state[i] = v ? 0 : RESOLVED;
    cnt += v;
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&ctl[0], cnt);
}

__global__ void reserve_kernel(const uint4* __restrict__ table,
                               const uint4* __restrict__ keys,
                               const uint8_t* __restrict__ valid,
                               const int* __restrict__ bkt,
                               int* __restrict__ probe,
                               const uint8_t* __restrict__ state,
                               unsigned long long* res, const int* ctl,
                               long long n, int rt_mask, int T,
                               int max_iters, int phase, int r) {
  if (!round_active(ctl, phase, r, T, max_iters)) return;
  const unsigned long long tag = round_tag(phase, r, max_iters);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    if (state[i] & (RESOLVED | EXCLUDED)) continue;
    const uint4 k = load_key(keys, valid, i);
    const int b = bkt[i];
    const uint4* line = table + (long long)b * BKT;
    bool eq = false;
    int fe = -1;
#pragma unroll
    for (int s = 0; s < BKT; ++s) {
      const uint4 e = line[s];
      eq |= (e.x == k.x) & (e.y == k.y) & (e.z == k.z) & (e.w == k.w);
      if (fe < 0 && (e.x & e.y & e.z & e.w) == 0xffffffffu) fe = s;
    }
    const bool he = fe >= 0;
    probe[i] = (eq ? 1 : 0) | (he ? 2 : 0) | ((he ? fe : 0) << 4);
    if (!eq && he) atomicMin(&res[b & rt_mask], tag | (unsigned long long)i);
  }
}

__global__ void claim_kernel(uint4* __restrict__ table,
                             const uint4* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             int* __restrict__ bkt,
                             const int* __restrict__ probe,
                             uint8_t* __restrict__ state,
                             const unsigned long long* __restrict__ res,
                             int* ctl, long long n, int rt_mask,
                             unsigned vb_mask, int T, int max_iters,
                             int phase, int r) {
  if (!round_active(ctl, phase, r, T, max_iters)) return;
  const unsigned long long tag = round_tag(phase, r, max_iters);
  int left = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const uint8_t st = state[i];
    if (st & (RESOLVED | EXCLUDED)) continue;
    const int p = probe[i];
    const bool eq = p & 1, he = (p & 2) != 0;
    const int b = bkt[i];
    const bool winner =
        !eq && he && res[b & rt_mask] == (tag | (unsigned long long)i);
    if (winner) table[(long long)b * BKT + (p >> 4)] = load_key(keys, valid, i);
    if (eq || winner) {
      state[i] = st | RESOLVED | (winner ? INSERTED : 0);
    } else {
      if (!he) {
        const uint4 k = load_key(keys, valid, i);
        bkt[i] = (int)(((unsigned)b + (k.y | 1u)) & vb_mask);
      }
      ++left;
    }
  }
  left = __reduce_add_sync(0xffffffffu, left);
  if ((threadIdx.x & 31) == 0 && left)
    atomicAdd(&ctl[phase == 0 ? 2 + r : 2 + max_iters + r], left);
}

// One block: U = keys left by the last full round.  The tail admits the
// lowest-index min(U, T); when U > T the others are marked EXCLUDED by a
// block-wide scan in index order.
__global__ void __launch_bounds__(SELECT_THREADS)
select_tail_kernel(uint8_t* __restrict__ state, int* ctl, long long n,
                   int T, int max_iters) {
  __shared__ int s_u;
  typedef cub::BlockScan<int, SELECT_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  if (threadIdx.x == 0) {
    int u = 0;
    if (ctl[0] > 0) {
      int r = 0;
      while (r + 1 < max_iters && ctl[2 + r] > T) ++r;
      u = ctl[2 + r];
    }
    ctl[1] = u < T ? u : T;
    s_u = u;
  }
  __syncthreads();
  if (s_u <= T) return;
  int base = 0;
  for (long long off = 0; off < n; off += SELECT_THREADS) {
    const long long i = off + threadIdx.x;
    const int f = (i < n && !(state[i] & RESOLVED)) ? 1 : 0;
    int excl, agg;
    Scan(tmp).ExclusiveSum(f, excl, agg);
    if (f && base + excl >= T) state[i] |= EXCLUDED;
    base += agg;
    __syncthreads();
  }
}

__global__ void finalize_kernel(const uint8_t* __restrict__ state,
                                uint8_t* __restrict__ inserted,
                                uint8_t* __restrict__ unresolved,
                                long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const uint8_t st = state[i];
    inserted[i] = (st & INSERTED) ? 1 : 0;
    unresolved[i] = (st & RESOLVED) ? 0 : 1;
  }
}

}  // namespace

// table [V+1, 4] u32 (updated in place), keys [n, 4] u32, valid [n] u8,
// inserted / unresolved [n] u8 (out); scratch: bkt [n] i32, probe [n]
// i32, state [n] u8, res [rt] u64 (all ones), ctl [2 + 2 * max_iters]
// i32 (zeros).  Launches on `stream`; returns cudaGetLastError().
extern "C" int dsl_visited_insert(void* table, const void* keys,
                                  const void* valid, void* inserted,
                                  void* unresolved, void* bkt, void* probe,
                                  void* state, void* res, void* ctl,
                                  long long n, long long V, long long rt,
                                  long long T, int max_iters, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  const unsigned vb_mask = (unsigned)(V / BKT - 1);
  const int rt_mask = (int)(rt - 1);
  const int t = (int)T;
  uint4* tb = (uint4*)table;
  const uint4* kb = (const uint4*)keys;
  const uint8_t* vb = (const uint8_t*)valid;
  int* bk = (int*)bkt;
  int* pr = (int*)probe;
  uint8_t* st = (uint8_t*)state;
  unsigned long long* rs = (unsigned long long*)res;
  int* c = (int*)ctl;
  init_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(kb, vb, bk, st, c, n,
                                                   vb_mask);
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 1)
      select_tail_kernel<<<1, SELECT_THREADS, 0, s>>>(st, c, n, t, max_iters);
    for (int r = 0; r < max_iters; ++r) {
      reserve_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
          tb, kb, vb, bk, pr, st, rs, c, n, rt_mask, t, max_iters, phase, r);
      claim_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
          tb, kb, vb, bk, pr, st, rs, c, n, rt_mask, vb_mask, t, max_iters,
          phase, r);
    }
  }
  finalize_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      st, (uint8_t*)inserted, (uint8_t*)unresolved, n);
  return (int)cudaGetLastError();
}
