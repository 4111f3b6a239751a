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
// the table as it stood at the start of the round.  A key that wants a
// slot does an atomicMin of its batch index into res[bucket & (RT - 1)];
// the minimum wins and writes its key to the first empty slot; losers
// stay on the bucket; keys of a full bucket move on by their step.
// Phases:
//   full: at least one round, then on while more than
//         T = max(N / 8, min(256, N)) keys are unresolved, at most
//         max_iters rounds;
//   tail: the lowest-index min(U, T) unresolved keys get up to max_iters
//         more rounds; any others stay unresolved.
// Ranking tail keys by their batch index is the same tie-break order as
// the reference's rank inside the compacted tail, so winners agree.
//
// Structure: one persistent cooperative launch per insert.  The grid is
// as many blocks as the card holds at once (occupancy x SMs, computed
// once per device), and no more than the batch needs; it is launched
// with cudaLaunchCooperativeKernel, which makes grid-wide barriers legal
// and refuses a grid that could not be resident (the wrapper raises).
// Steps, separated by grid barriers:
//   init     inserted = 0, unresolved = valid, reservation cells all
//            ones, round counters zero;
//   reserve  each key of the round's list reads its bucket line and takes
//            its atomicMin reservation; the table is only read;
//   claim    winners write their key, resolved keys clear `unresolved`,
//            the others are appended to the next round's list; the table
//            is only written;
//   select   only when more than T keys outlive the full phase: each
//            block counts the unresolved keys of its own index tile, adds
//            the counts of the blocks before it, and ranks its keys, so
//            the tail list holds the lowest-index T in index order.
// After each claim every block reads the same per-round counter and takes
// the same branch: the rounds end on the device, and the host never
// synchronises inside an insert.
//
// Worklist: round 0 walks the batch; each later round reads only the
// (index, bucket) entries the previous claim appended (a block-wide scan,
// then one atomicAdd per block and pass), in no particular order.  Order
// does not change the result: at most one key per reservation cell, so
// per bucket, wins a round; the winner is the minimum batch index; and
// every key reads its line as it stood at the start of the round.
//
// Probe: eight lanes share a key and each loads one 16-byte slot, so a
// warp reads four whole 128-byte lines per load instruction.  Ballots
// give the eq and empty masks; __ffs gives the lowest empty slot, the
// reference's argmax.  Each group fetches its next entry and key while
// its current line is in flight.  Data that the kernel itself writes is
// read with __ldcg (L2, not a block's L1), so no block sees a line older
// than the last barrier.
//
// Reservation cells hold (~round << 32) | index: a later round always
// beats a stale entry, so `res` is filled once per call.
//
// Bound: bytes.  The least traffic reads each key (16 B) and valid byte
// once and one 128-byte bucket line per valid key, and writes each
// inserted key (16 B) and two flag bytes per key.  What still keeps the
// kernel from it: round 0 reads one random 128-byte line per valid key,
// and random lines come from memory well below its streaming rate; the
// winners' 16-byte writes land on random lines too; the reservation
// cells (8 B per RT cell) are filled on every call; and every round
// costs two grid barriers, each a few microseconds, so the tail rounds,
// which hold few keys, cost their barriers and little else.  Later work:
// finishing rounds that hold few keys inside one block (block barriers
// instead of grid ones), a cheaper grid barrier, and deeper prefetch of
// list entries and lines (cp.async or TMA gathers into shared memory).

#include <cooperative_groups.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BKT = 8;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// 8-lane groups: keys probed by a warp, and by a block, per pass.
constexpr int WARP_KEYS = 32 / BKT;
constexpr int BLOCK_KEYS = THREADS / BKT;
constexpr int MAX_DEVICES = 64;

struct Args {
  uint4* table;
  const uint4* keys;
  const uint8_t* valid;
  uint8_t* inserted;
  uint8_t* unresolved;
  int2* lists;  // [2, n] round lists of (index, bucket), used in turn
  int2* probe;  // [n] per list position: (bucket, eq | has_empty << 1 |
                // first_empty << 2); select reuses its first words
  int* bkt;     // [n] select only: each listed key's bucket, by index
  unsigned long long* res;  // [rt] reservation cells
  int* ctl;     // [2 * max_iters] ctl[r]: keys left by full round r;
                // ctl[max_iters + t]: by tail round t
  int n, rt_mask, T, max_iters;
  unsigned vb_mask;
};

typedef cub::BlockReduce<int, THREADS> Reduce;
typedef cub::BlockScan<int, THREADS> Scan;
struct Shared {
  union {
    typename Reduce::TempStorage reduce;
    typename Scan::TempStorage scan;
  } tmp;
  int word;  // a block-wide value: a list offset, a count
};

// The key of a valid row as the table stores it.
__device__ __forceinline__ uint4 sanitise(uint4 k) {
  if ((k.x & k.y & k.z & k.w) == 0xffffffffu) k.w = 0xfffffffeu;
  return k;
}

__device__ __forceinline__ unsigned long long round_tag(int round) {
  return (unsigned long long)(0xffffffffu - (unsigned)round) << 32;
}

// Entry p of a round's list: `lst`, or the batch when `lst` == nullptr
// (round 0: entry p is key p at its home bucket, invalid rows skipped).
// Sets the entry (index, bucket) and the raw key; returns whether it
// holds a key to probe.
__device__ __forceinline__ bool fetch(const Args& a, const int2* lst,
                                      int len, long long p, int2& e,
                                      uint4& k) {
  if (p >= len) return false;
  if (lst) {
    e = __ldcg(lst + p);
    k = __ldg(a.keys + e.x);
    return true;
  }
  k = __ldg(a.keys + p);
  e = make_int2((int)p, (int)(k.z & a.vb_mask));
  return __ldg(a.valid + p);
}

// Each 8-lane group probes one entry per pass and fetches its next entry
// and key while the current line is in flight.
__device__ void reserve(const Args& a, const int2* lst, int len,
                        unsigned long long tag) {
  const int lane = threadIdx.x & 31, g = lane >> 3, s = lane & 7;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long stride = (long long)gridDim.x * WARPS * WARP_KEYS;
  long long base = warp * WARP_KEYS;
  int2 e = make_int2(0, 0);
  uint4 k = make_uint4(0, 0, 0, 0);
  bool act = fetch(a, lst, len, base + g, e, k);
  for (; base < len; base += stride) {
    uint4 slot = make_uint4(0, 0, 0, 0);
    if (act) slot = __ldcg(a.table + (long long)e.y * BKT + s);
    int2 e_next = make_int2(0, 0);
    uint4 k_next = make_uint4(0, 0, 0, 0);
    const bool act_next = fetch(a, lst, len, base + stride + g, e_next,
                                k_next);
    k = sanitise(k);
    const unsigned eqm = __ballot_sync(
        0xffffffffu, act && slot.x == k.x && slot.y == k.y &&
                         slot.z == k.z && slot.w == k.w);
    const unsigned emm = __ballot_sync(
        0xffffffffu,
        act && (slot.x & slot.y & slot.z & slot.w) == 0xffffffffu);
    if (act && s == 0) {
      const unsigned eq = (eqm >> (g * BKT)) & 0xffu;
      const unsigned em = (emm >> (g * BKT)) & 0xffu;
      const int fe = em ? __ffs(em) - 1 : 0;
      a.probe[base + g] =
          make_int2(e.y, (eq ? 1 : 0) | (em ? 2 : 0) | (fe << 2));
      if (!eq && em)
        atomicMin(a.res + (e.y & a.rt_mask), tag | (unsigned long long)e.x);
    }
    e = e_next;
    k = k_next;
    act = act_next;
  }
}

// Appends the keys it leaves unresolved to `next`, counting them in
// `*left` with one atomicAdd per block and pass.  Two dependent trips per
// entry: the entry and its probe word, then the reservation cell and the
// key.
__device__ void claim(const Args& a, const int2* lst, int len, int2* next,
                      int* left, unsigned long long tag, Shared& sh) {
  for (long long base = (long long)blockIdx.x * THREADS; base < len;
       base += (long long)gridDim.x * THREADS) {
    const long long p = base + threadIdx.x;
    bool keep = false;
    int i = 0, nb = 0;
    if (p < len) {
      i = lst ? __ldcg(&lst[p].x) : (int)p;
      const bool act = lst || __ldg(a.valid + p);
      const int2 pr = __ldcg(a.probe + p);
      const bool eq = pr.y & 1, he = (pr.y & 2) != 0;
      if (act && !eq) {
        const uint4 k = __ldg(a.keys + i);
        const bool win = he && __ldcg(a.res + (pr.x & a.rt_mask)) ==
                                   (tag | (unsigned long long)i);
        if (win) {
          a.table[(long long)pr.x * BKT + (pr.y >> 2)] = sanitise(k);
          a.inserted[i] = 1;
          a.unresolved[i] = 0;
        } else {
          keep = true;
          nb = he ? pr.x : (int)(((unsigned)pr.x + (k.y | 1u)) & a.vb_mask);
        }
      } else if (act) {
        a.unresolved[i] = 0;
      }
    }
    int at, total;
    Scan(sh.tmp.scan).ExclusiveSum(keep ? 1 : 0, at, total);
    if (threadIdx.x == 0 && total) sh.word = atomicAdd(left, total);
    __syncthreads();
    if (keep) next[sh.word + at] = make_int2(i, nb);
    __syncthreads();
  }
}

// The lowest-index T of the `len` keys listed in `cur` (the unresolved
// ones), in index order, into `out`.
__device__ void select_tail(const Args& a, const int2* cur, int len,
                            int2* out, Shared& sh) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long p = tid; p < len; p += (long long)gridDim.x * THREADS) {
    const int2 e = __ldcg(cur + p);
    a.bkt[e.x] = e.y;
  }
  const long long tile = (a.n + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = lo + tile < a.n ? lo + tile : a.n;
  int* counts = (int*)a.probe;
  int cnt = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS)
    cnt += __ldcg(a.unresolved + i);
  cnt = Reduce(sh.tmp.reduce).Sum(cnt);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
  cg::this_grid().sync();
  int before = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += THREADS)
    before += __ldcg(counts + j);
  __syncthreads();
  before = Reduce(sh.tmp.reduce).Sum(before);
  if (threadIdx.x == 0) sh.word = before;
  __syncthreads();
  before = sh.word;
  for (long long off = lo; off < hi && before < a.T; off += THREADS) {
    const long long i = off + threadIdx.x;
    const int f = (i < hi && __ldcg(a.unresolved + i)) ? 1 : 0;
    int excl, agg;
    Scan(sh.tmp.scan).ExclusiveSum(f, excl, agg);
    if (f && before + excl < a.T)
      out[before + excl] = make_int2((int)i, __ldcg(a.bkt + i));
    before += agg;
    __syncthreads();
  }
  cg::this_grid().sync();
}

// One round: reserve, barrier, claim, barrier.  Returns the keys left.
__device__ __forceinline__ int run_round(const Args& a, const int2* lst,
                                         int len, int2* next, int* left,
                                         int round, Shared& sh) {
  const unsigned long long tag = round_tag(round);
  reserve(a, lst, len, tag);
  cg::this_grid().sync();
  claim(a, lst, len, next, left, tag, sh);
  cg::this_grid().sync();
  return __ldcg(left);
}

__global__ void __launch_bounds__(THREADS)
insert_coop_kernel(Args a) {
  __shared__ Shared sh;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)gridDim.x * THREADS;
  for (long long i = tid; i < a.n; i += nthr) {
    a.inserted[i] = 0;
    a.unresolved[i] = __ldg(a.valid + i);
  }
  for (long long c = tid; c <= a.rt_mask; c += nthr) a.res[c] = ~0ull;
  for (long long c = tid; c < 2LL * a.max_iters; c += nthr) a.ctl[c] = 0;
  cg::this_grid().sync();

  // Two list buffers in turn: `out` is always the one `cur` is not.
  int2* const lists[2] = {a.lists, a.lists + a.n};
  const int2* cur = nullptr;  // round 0 walks the batch
  int2* out = lists[0];
  int len = a.n;
  for (int r = 0;; ++r) {
    len = run_round(a, cur, len, out, a.ctl + r, r, sh);
    cur = out;
    out = out == lists[0] ? lists[1] : lists[0];
    if (len <= a.T || r + 1 == a.max_iters) break;
  }
  if (len > a.T) {
    select_tail(a, cur, len, out, sh);
    cur = out;
    out = out == lists[0] ? lists[1] : lists[0];
    len = a.T;
  }
  for (int t = 0; t < a.max_iters && len > 0; ++t) {
    len = run_round(a, cur, len, out, a.ctl + a.max_iters + t,
                    a.max_iters + t, sh);
    cur = out;
    out = out == lists[0] ? lists[1] : lists[0];
  }
}

// Blocks of insert_coop_kernel the device holds at once, per device.
cudaError_t resident_blocks(int* blocks) {
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, insert_coop_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < MAX_DEVICES) cache[dev] = per_sm * sms;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// table [V+1, 4] u32 (updated in place), keys [n, 4] u32, valid [n] u8,
// inserted / unresolved [n] u8 (out); scratch, uninitialised: bkt [n]
// i32, probe [n, 2] i32, lists [2, n, 2] i32, res [rt] u64, ctl
// [2 * max_iters] i32.  n <= 2^30, V <= 2^34.  One cooperative launch on
// `stream`; returns the launch's error, else cudaGetLastError().
extern "C" int dsl_visited_insert_coop(void* table, const void* keys,
                                       const void* valid, void* inserted,
                                       void* unresolved, void* bkt,
                                       void* probe, void* lists, void* res,
                                       void* ctl, long long n, long long V,
                                       long long rt, long long T,
                                       int max_iters, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n > (1LL << 30) || rt > (1LL << 31) || V / BKT > (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + BLOCK_KEYS - 1) / BLOCK_KEYS;
  if (blocks > resident) blocks = resident;
  Args a;
  a.table = (uint4*)table;
  a.keys = (const uint4*)keys;
  a.valid = (const uint8_t*)valid;
  a.inserted = (uint8_t*)inserted;
  a.unresolved = (uint8_t*)unresolved;
  a.bkt = (int*)bkt;
  a.probe = (int2*)probe;
  a.lists = (int2*)lists;
  a.res = (unsigned long long*)res;
  a.ctl = (int*)ctl;
  a.n = (int)n;
  a.rt_mask = (int)(rt - 1);
  a.T = (int)T;
  a.max_iters = max_iters;
  a.vb_mask = (unsigned)(V / BKT - 1);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)insert_coop_kernel,
                                    dim3((unsigned)blocks), dim3(THREADS),
                                    params, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
