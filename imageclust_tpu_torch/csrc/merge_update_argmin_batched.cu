// Batched constrained-Ward merge step for Hopper (sm_90a): one iteration of
// the bucketed engine's lockstep loop, with cached per-bucket row minima and
// the loop's integer bookkeeping fused in.
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin_batched
// (kernel body _merge_step_kernel_batched, per-bucket reduce at :342-350)
// and, in a loop call, the integer part of the lockstep body around it
// (imageclust_tpu/cluster/sharded.py:705-765). One launch works on a chunk
// of C buckets, each with its own (B, B) Ward matrix D[c], its own pending
// update and its own control word ctl[c] (LCTL_* in ops/merge_kernels.py):
//   1. applies bucket c's PENDING row/column update of slot sa when
//      ctl[c].do != 0: D[c, sa, :] = dvec[c] and D[c, :, sa] = dvec[c] (the
//      row write wins at [sa, sa]). Frozen buckets too, as the JAX loop's
//      vmapped while_loop does: the write is idempotent;
//   2. decides whether bucket c runs this iteration, as the JAX run_fns do:
//      main phase (amin < 0) found & (num_active > target), absorb phase
//      (amin >= 0) found & any(active & sizes < amin); a call without a
//      loop runs every bucket. A loop call reads the phase's amin from
//      device memory (flags), so one CUDA graph serves both phases;
//   3. for a running bucket, brings the per-row cache up to date (below)
//      and reduces it to the next feasible pair: the minimum of D[c, r, s]
//      over active r != s with sizes[r] + sizes[s] <= max_size and, when
//      amin > 0, sizes[r] < amin or sizes[s] < amin, ties broken by the
//      lexicographically smallest (max birth, min birth). Outputs per bucket
//      (dmin f32, bhi i32, blo i32); (+inf, INT32_MAX, INT32_MAX) when no
//      pair is feasible or the bucket does not run;
//   4. in a loop call, the lockstep body's bookkeeping for each running
//      bucket, gated on proceed = (dmin is finite): sizes, births, active,
//      the log row (bhi, blo, counter), counter, num_active, step, found,
//      the next pending sa / do, and (sa, sb, s_a, s_b, proceed) for the
//      float work that computes the next dvec; and the chunk's "a bucket
//      ran" flag with its count of such iterations.
// Steps 3-4 of bucket c run in the last of its blocks to finish (a ticket
// in ctl[c] after a __threadfence), which resets the ticket; the last
// bucket to finish (a second ticket) sets the chunk's flag and resets that
// ticket, so a CUDA graph replay finds both at zero. Nothing synchronises
// with the host and nothing is allocated.
//
// The cache is K1's (csrc/merge_update_argmin.cu, where the comment proves
// it exact) with a bucket axis: per row of every bucket, the minimum over
// its feasible columns as cache_key.cuh's key and the column (-1: none), in
// the caller's workspace (16 bytes a row: 2.1 MB at C = 261, B = 512). A
// bucket's first running call in a phase (ctl[c].filled == 0; the loop
// clears it when a phase begins, since the absorb phase's mask changes the
// feasibility of every pair) and every call without a loop scan every
// active row in full. A later running call, after the merge (sa, sb) that
// the previous call decided, rescans row sa, the rows whose cached column
// is sa, and the rows whose cached column is no longer active (sb); every
// other active row folds in its one new candidate, column sa, if that pair
// is feasible under the new sizes and the phase's absorb mask. Within a
// phase a bucket that stops running never runs again (found only changes
// where it runs, num_active only where it merges), so its cache is not
// touched after it stops, and is refilled in the next phase. Searches span
// the full B x B feasible set (no triangle): D from a Gram product need not
// be bit-symmetric.
//
// Design. Blocks of 64 threads own 32 rows of one bucket each (grid
// (ceil(B / 32), C): 4176 blocks at C = 261, B = 512, one wave at 32
// blocks an SM). Every read and write of a row happens in its owner block.
// Warp 0 (a lane per row) writes column sa, folds, and lists the rows to
// rescan; each row on the list is scanned by one warp, 8 coalesced 4-byte
// loads in flight per lane (any B), and reduced with redux.sync on the
// packed key. Each block leaves the minimum over its rows; the bucket's
// last block reduces its ceil(B / 32) partials and does the bookkeeping.
//
// What bounds it on this card: a full scan reads every active row of every
// running bucket (274 MB at a 100,000-image job's chunk, C = 261, B = 512,
// above the 50 MB L2), so it is bound by device-memory bytes. A cached call
// writes row and column sa of each bucket and reads the rescanned rows
// (a few per bucket on normal data; counted in ctl[c].rescans..), the
// cache and the metadata: some 10 MB over the chunk, a few microseconds at
// the card's rate, so the launch, the block waves and the chain of
// dependent loads in a block (control word, metadata, cache, a row, the
// partials, the bookkeeping) bound it. Under heavy ties many rows point at
// one column; a call then rescans many rows, never more than one full scan.
// There is no arithmetic on D: only `<` / `==` compares and selects, so
// results are bit-identical to the plain PyTorch twin. Built with
// -fmad=false like every kernel of the port.
//
// The float work (merged centroids, the centroid or Lance-Williams row
// dvec, the centroid scatter) stays in PyTorch ops shared with the twin's
// loop (cluster/sharded.py): fusing the centroid rule's row sum in here
// would change its summation order against torch.sum.

#include "cache_key.cuh"

namespace {

using namespace ic;  // the cache's key (cache_key.cuh) and ic::kBig

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;  // warp 0 has a lane per row
constexpr int kUnroll = 8;         // loads in flight per lane in a row scan

// ctl (C, kCtlLen): int32 fields shared with ops/merge_kernels.py (LCTL_*).
enum Ctl {
  kSa = 0,           // pending slot of the next call's update
  kDo = 1,           // the next call applies it
  kCounter = 2,      // next birth stamp
  kStep = 3,         // merges performed: the next log row
  kNumActive = 4,    // active slots
  kTarget = 5,       // the main phase runs while num_active > target
  kFound = 6,        // the last running call found a pair
  kFilled = 7,       // the cache holds every active row's minimum
  kTicket = 8,       // blocks finished in this call; the last one resets it
  kRescans = 9,      // rows rescanned in this call (reset by the last block)
  kRescanTotal = 10,  // rows rescanned by every cached call so far
  kRescanMax = 11,    // most rows rescanned by one cached call
  kCachedCalls = 12,  // running calls that used the cache
  kCtlLen = 13,
};

// flags (5,): the chunk's, shared with ops/merge_kernels.py (LFLAG_*).
enum Flag {
  kAnyRan = 0,   // some bucket ran in the last call
  kIters = 1,    // calls in which some bucket ran
  kChunkTicket = 2,  // buckets finished in this call
  kRanAcc = 3,   // some bucket ran in this call (reset by the last)
  kAmin = 4,     // the phase: < 0 main; >= 0 absorb (mask when > 0)
};

struct Args {
  float* D;
  const float* dvec;
  int32_t* births;
  int32_t* sizes;
  int32_t* active;
  int32_t* ctl;
  int C;
  int B;
  int G;  // row blocks a bucket
  int max_size;
  int amin;  // a loop call reads flags[kAmin] instead
  // workspace
  u64* row_key;
  uint32_t* row_lo;
  int32_t* row_col;
  u64* part_key;
  uint32_t* part_lo;
  int32_t* part_row;
  int32_t* part_col;
  // outputs of every call
  float* out_d;       // (C,)
  int32_t* out_pair;  // (C, 2)
  // loop calls only (null otherwise)
  int32_t* log;       // (C, max(B - 1, 1), 3)
  long long* pair;    // (C, 2)
  float* pair_f;      // (C, 3)
  uint8_t* proceed;   // (C,)
  int32_t* flags;     // (5,)
};

struct Shared {
  u64 key[kRowsPerBlock];  // this block's rows, as the call leaves them
  uint32_t lo[kRowsPerBlock];
  int32_t col[kRowsPerBlock];
  int32_t list[kRowsPerBlock];  // rows to scan in full
  int32_t n_list;
  bool last;
};

// Row r of bucket c scanned in full by one warp: its minimum (key, column)
// in every lane.
__device__ __forceinline__ Key scan_row(const Args& a, const float* Dc, const int32_t* bc,
                                        const int32_t* sc, const int32_t* ac, const int r,
                                        const int amin, int& col) {
  const int lane = threadIdx.x & 31;
  const int B = a.B;
  const float* row = Dc + static_cast<size_t>(r) * B;
  const int32_t b_r = bc[r];
  const int32_t s_r = sc[r];
  const bool under_r = s_r < amin;
  Best best = identity();
  col = kNone;
  for (int j0 = 0; j0 < B; j0 += 32 * kUnroll) {
    float d[kUnroll];
    int32_t bb[kUnroll], ss[kUnroll], aa[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      d[u] = 0.f;
      bb[u] = ss[u] = aa[u] = 0;
      if (j < B) {
        d[u] = row[j];
        bb[u] = bc[j];
        ss[u] = sc[j];
        aa[u] = ac[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      if (aa[u] > 0 && j != r && s_r + ss[u] <= a.max_size &&
          (amin <= 0 || under_r || ss[u] < amin)) {
        take_at(best, col, d[u], max(b_r, bb[u]), min(b_r, bb[u]), j);
      }
    }
  }
  Key key = to_key(best, col);
  int unused = 0;
  warp_min(key, col, unused);
  return key;
}

// The bucket's last block, warp 0: its pair from the partials, the outputs,
// the bookkeeping, and the chunk's ticket.
__device__ __forceinline__ void finish(const Args& a, const int c, const bool run,
                                       const bool cached) {
  const int lane = threadIdx.x & 31;
  const int B = a.B;
  const size_t base = static_cast<size_t>(c) * B;
  int32_t* ctl = a.ctl + static_cast<size_t>(c) * kCtlLen;
  Key key = no_key();
  int row = kNone, col = kNone;
  if (run) {
    const size_t p0 = static_cast<size_t>(c) * a.G;
    for (int i = lane; i < a.G; i += 32) {
      const Key k{__ldcg(a.part_key + p0 + i), __ldcg(a.part_lo + p0 + i)};
      if (less(k, key)) {
        key = k;
        row = __ldcg(a.part_row + p0 + i);
        col = __ldcg(a.part_col + p0 + i);
      }
    }
  }
  warp_min(key, row, col);
  if (lane != 0) return;

  const bool any = key.k != kNoKey;
  const float d = any ? dvalue(static_cast<uint32_t>(key.k >> 32)) : CUDART_INF_F;
  const int32_t hi = any ? bvalue(static_cast<uint32_t>(key.k)) : kBig;
  const int32_t lo = any ? bvalue(key.lo) : kBig;
  a.out_d[c] = d;
  a.out_pair[2 * c] = hi;
  a.out_pair[2 * c + 1] = lo;
  if (a.log != nullptr) {
    int32_t* births = a.births + base;
    int32_t* sizes = a.sizes + base;
    const bool proceed = run && isfinite(d);
    int32_t sa = 0, sb = 0, s_a = 0, s_b = 0;
    if (proceed) {
      const bool row_is_a = births[row] > births[col];
      sa = row_is_a ? row : col;
      sb = row_is_a ? col : row;
      s_a = sizes[sa];
      s_b = sizes[sb];
      const int32_t nb = ctl[kCounter];
      const int32_t step = ctl[kStep];
      const int n_log = max(B - 1, 1);
      sizes[sa] = s_a + s_b;
      sizes[sb] = 0;
      a.active[base + sb] = 0;
      births[sa] = nb;
      int32_t* out = a.log + (static_cast<size_t>(c) * n_log + min(step, n_log - 1)) * 3;
      out[0] = hi;
      out[1] = lo;
      out[2] = nb;
      ctl[kCounter] = nb + 1;
      ctl[kStep] = step + 1;
      ctl[kNumActive] -= 1;
      ctl[kSa] = sa;
    }
    if (run) {
      ctl[kFound] = proceed ? 1 : 0;
      ctl[kDo] = proceed ? 1 : 0;
      ctl[kFilled] = 1;
      if (cached) {
        const int32_t rescans = atomicExch(ctl + kRescans, 0);
        ctl[kRescanTotal] += rescans;
        ctl[kRescanMax] = max(ctl[kRescanMax], rescans);
        ctl[kCachedCalls] += 1;
      }
      atomicOr(a.flags + kRanAcc, 1);
    }
    a.pair[2 * c] = sa;
    a.pair[2 * c + 1] = sb;
    a.pair_f[3 * c] = static_cast<float>(s_a);
    a.pair_f[3 * c + 1] = static_cast<float>(s_b);
    a.pair_f[3 * c + 2] = static_cast<float>(s_a + s_b);
    a.proceed[c] = proceed ? 1 : 0;
    __threadfence();
    if (atomicAdd(a.flags + kChunkTicket, 1) == a.C - 1) {
      __threadfence();
      const int32_t ran = atomicExch(a.flags + kRanAcc, 0);
      a.flags[kAnyRan] = ran;
      a.flags[kIters] += ran;
      a.flags[kChunkTicket] = 0;
    }
  }
  ctl[kTicket] = 0;
}

__global__ void __launch_bounds__(kThreads) lockstep_step_kernel(const Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.y;
  const int B = a.B;
  const size_t base = static_cast<size_t>(c) * B;
  float* Dc = a.D + base * B;
  const float* dv = a.dvec + base;
  const int32_t* bc = a.births + base;
  const int32_t* sc = a.sizes + base;
  const int32_t* ac = a.active + base;
  int32_t* ctl = a.ctl + static_cast<size_t>(c) * kCtlLen;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int sa = ctl[kSa];
  const bool upd = ctl[kDo] != 0;
  const bool loop = a.log != nullptr;
  const int amin = loop ? a.flags[kAmin] : a.amin;

  // does the bucket run? (uniform across the block)
  bool run = true;
  if (loop && amin < 0) {
    run = ctl[kFound] != 0 && ctl[kNumActive] > ctl[kTarget];
  } else if (loop) {
    bool under = false;
    if (ctl[kFound] != 0) {
      for (int r = tid; r < B; r += kThreads) under |= ac[r] > 0 && sc[r] < amin;
    }
    run = __syncthreads_or(under) != 0;
  }
  // without a loop the cache is scratch: always one full scan
  const bool cached = loop && ctl[kFilled] != 0;

  // 1. the pending update of this block's rows: row sa whole, column sa
  if (upd && sa >= row0 && sa < row0 + kRowsPerBlock) {
    float* dst = Dc + static_cast<size_t>(sa) * B;
    for (int j = tid; j < B; j += kThreads) dst[j] = dv[j];
  }
  if (warp == 0) {
    const int r = row0 + lane;
    const bool in = r < B;
    if (upd && in && r != sa) Dc[static_cast<size_t>(r) * B + sa] = dv[r];
    // 2. which rows to scan in full; the others fold in column sa
    bool scan = false;
    Key key = no_key();
    int col = kNone;
    if (run && in && ac[r] > 0) {
      if (!cached) {
        scan = true;
      } else {
        const size_t w = base + r;
        key = Key{a.row_key[w], a.row_lo[w]};
        col = a.row_col[w];
        if (upd) {
          if (r == sa || col == sa || (col != kNone && ac[col] <= 0)) {
            scan = true;
          } else {
            const float dr = dv[r];
            const int32_t s_r = sc[r];
            const int32_t s_a = sc[sa];
            if (s_r + s_a <= a.max_size && (amin <= 0 || s_r < amin || s_a < amin) &&
                !isnan(dr)) {
              const Key cand = pair_key(dr, bc[r], bc[sa]);
              if (less(cand, key)) {
                key = cand;
                col = sa;
                a.row_key[w] = cand.k;
                a.row_lo[w] = cand.lo;
                a.row_col[w] = sa;
              }
            }
          }
        }
      }
    }
    sh.key[lane] = key.k;
    sh.lo[lane] = key.lo;
    sh.col[lane] = col;
    const uint32_t mask = __ballot_sync(kFull, scan);
    if (scan) sh.list[__popc(mask & ((1u << lane) - 1u))] = r;
    if (lane == 0) {
      sh.n_list = __popc(mask);
      if (cached && mask != 0u) atomicAdd(ctl + kRescans, __popc(mask));
    }
  }
  __syncthreads();  // column and row sa written, the list whole

  // 3. the full scans, a warp a row
  const int n_list = sh.n_list;
  for (int i = warp; i < n_list; i += kWarps) {
    const int r = sh.list[i];
    int col;
    const Key key = scan_row(a, Dc, bc, sc, ac, r, amin, col);
    if (lane == 0) {
      const int local = r - row0;
      sh.key[local] = key.k;
      sh.lo[local] = key.lo;
      sh.col[local] = col;
      a.row_key[base + r] = key.k;
      a.row_lo[base + r] = key.lo;
      a.row_col[base + r] = col;
    }
  }
  __syncthreads();

  // 4. this block's minimum, then the bucket's ticket
  if (warp == 0) {
    Key key{sh.key[lane], sh.lo[lane]};
    int row = row0 + lane, col = sh.col[lane];
    warp_min(key, row, col);
    if (lane == 0) {
      const size_t p = static_cast<size_t>(c) * a.G + blockIdx.x;
      a.part_key[p] = key.k;
      a.part_lo[p] = key.lo;
      a.part_row[p] = row;
      a.part_col[p] = col;
      __threadfence();
      sh.last = atomicAdd(ctl + kTicket, 1) == a.G - 1;
    }
  }
  __syncthreads();
  if (!sh.last || warp != 0) return;
  __threadfence();
  finish(a, c, run, cached);
}

}  // namespace

extern "C" {

// Bytes of the workspace for C buckets of B slots: the cache (16 bytes a
// row) and the per-block partials (20 bytes a block).
long long ic_lockstep_workspace_bytes(int C, int B) {
  const long long R = static_cast<long long>(C) * B;
  const long long P = static_cast<long long>(C) * ((B + kRowsPerBlock - 1) / kRowsPerBlock);
  return 16LL * R + 20LL * P;
}

// All pointers are device pointers. D (C, B, B) f32, dvec (C, B) f32,
// births, sizes, active (C, B) int32, ctl (C, 13) int32 (LCTL_* in
// ops/merge_kernels.py: the pending sa / do, and in a loop the bucket's
// counters; every ticket 0), ws the workspace (ic_lockstep_workspace_bytes),
// out_d (C,) f32, out_pair (C, 2) int32. A loop call passes log (C,
// max(B - 1, 1), 3) int32, pair (C, 2) int64, pair_f (C, 3) f32, proceed
// (C,) uint8 and flags (5,) int32, whose flags[4] holds the phase's amin
// (< 0 for the main phase, the minimum size for the absorb phase; the
// argument amin is not read); a call without a loop passes null for all
// five and its amin (<= 0: no absorb mask), runs every bucket with a full
// scan, and changes only D and the outputs. The absorb mask applies when
// amin > 0. Returns the cudaError_t of the launch (0 on success).
int ic_lockstep_step(void* D, const void* dvec, void* births, void* sizes, void* active,
                     void* ctl, int C, int B, int max_size, int amin, void* ws, void* out_d,
                     void* out_pair, void* log, void* pair, void* pair_f, void* proceed,
                     void* flags, void* stream) {
  const int G = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long R = static_cast<long long>(C) * B;
  const long long P = static_cast<long long>(C) * G;
  char* w = static_cast<char*>(ws);
  Args a;
  a.D = static_cast<float*>(D);
  a.dvec = static_cast<const float*>(dvec);
  a.births = static_cast<int32_t*>(births);
  a.sizes = static_cast<int32_t*>(sizes);
  a.active = static_cast<int32_t*>(active);
  a.ctl = static_cast<int32_t*>(ctl);
  a.C = C;
  a.B = B;
  a.G = G;
  a.max_size = max_size;
  a.amin = amin;
  a.row_key = reinterpret_cast<u64*>(w);
  a.row_lo = reinterpret_cast<uint32_t*>(w + 8LL * R);
  a.row_col = reinterpret_cast<int32_t*>(w + 12LL * R);
  a.part_key = reinterpret_cast<u64*>(w + 16LL * R);
  a.part_lo = reinterpret_cast<uint32_t*>(w + 16LL * R + 8LL * P);
  a.part_row = reinterpret_cast<int32_t*>(w + 16LL * R + 12LL * P);
  a.part_col = reinterpret_cast<int32_t*>(w + 16LL * R + 16LL * P);
  a.out_d = static_cast<float*>(out_d);
  a.out_pair = static_cast<int32_t*>(out_pair);
  a.log = static_cast<int32_t*>(log);
  a.pair = static_cast<long long*>(pair);
  a.pair_f = static_cast<float*>(pair_f);
  a.proceed = static_cast<uint8_t*>(proceed);
  a.flags = static_cast<int32_t*>(flags);
  lockstep_step_kernel<<<dim3(G, C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
