// Constrained-Ward merge step for Hopper (sm_90a), with cached row minima
// and the exact loop's integer bookkeeping fused in.
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin (kernel
// body _merge_step_kernel). One launch:
//   1. applies the PENDING row/column update of slot `sa` to the n x n Ward
//      matrix D in place when do_update != 0: D[sa, :] = dvec and
//      D[:, sa] = dvec, in every row (the row write wins at D[sa, sa], as in
//      the Pallas body);
//   2. brings the per-row cache up to date (below);
//   3. reduces the cache to the next feasible pair: the minimum of D[r, c]
//      over pairs with active[r] > 0, active[c] > 0, r != c and
//      sizes[r] + sizes[c] <= max_size, ties broken by the lexicographically
//      smallest (max(births[r], births[c]), min(births[r], births[c])) -- the
//      Go scan order of the reference engine. Outputs (dmin f32, bhi i32,
//      blo i32); (+inf, INT32_MAX, INT32_MAX) when no pair is feasible;
//   4. in a loop call only: the exact loop's integer bookkeeping for that
//      pair (cluster/ward.py), gated on found = (dmin is finite) and
//      step < limit: sizes, births, active, the log row (bhi, blo, counter),
//      counter and step, the next call's pending sa / do_update, and (sa, sb,
//      s_a, s_b) for the float work that computes the next dvec.
// Steps 3 and 4 run in the last block to finish (an atomic ticket after a
// __threadfence), which resets the ticket, so a CUDA graph replay finds it
// at zero. Nothing synchronises with the host and nothing is allocated.
//
// The cache: per row r, the minimum over r's feasible columns in ic::take's
// (d, max birth, min birth) order, kept as cache_key.cuh's key (a 64-bit
// code of d and the max birth, the min birth's code) and the column (-1:
// none). Births keep all 32 bits: in the exact engine they
// reach 2 n_items, so the 13 bits of K2's key would not hold them. The
// cache lives in the caller's workspace in device memory (16 bytes a row:
// 64 KiB at n = 4096, L2-resident) and persists across a loop's calls.
// A loop's first call (ctl[FILLED] == 0) and every call without a loop
// scan every active row in full. A later loop call, after the merge
// (sa, sb) that the previous call decided, rescans in full:
//   * row sa;
//   * every active row whose cached column is sa;
//   * every active row whose cached column is no longer active (sb);
// and every other active row folds in its one new candidate, dvec[r] at
// column sa, if the pair is feasible under the new sizes.
// Why this is exact: a merge changes D only in row and column sa; it
// changes the feasibility (activity, size) only of pairs that involve sa
// or sb, and the tie key only of pairs that involve sa, whose birth is new.
// Sizes and births of every other slot stay as they were. So a row whose
// minimum was at a column other than sa and sb keeps that minimum over its
// unchanged columns, and its new minimum is the lesser of it and the one
// changed entry, column sa. Rows sa and sb and the rows that pointed at
// them are recomputed. Like the Pallas body, the full n x n feasible set is
// searched (no triangle): D from a Gram product need not be bit-symmetric.
// A cached call applies the pending update of the merge before it, so
// do_update == 0 (no merge before it) changes nothing and rescans nothing.
//
// The float work (the merged centroid, the centroid or Lance-Williams
// distance row dvec, the centroid scatter) stays in PyTorch ops shared with
// the plain twin's loop. Fusing the centroid rule's row sum in here would
// change its summation order against torch.sum, and merge logs would then
// differ from the twin loop's at near ties.
//
// Design. Blocks of 256 threads own 32 rows each (n / 32 blocks: 128 at
// n = 4096, one wave). Every read and write of a row happens in its owner
// block, so no block reads what another writes. Warp 0 (a lane per row)
// writes column sa, folds, and lists the rows to rescan; row sa is written
// whole by its owner block's threads as float4. Rows are scanned up to
// 8 at a time by the whole block: each thread loads one float4 of each row
// (8 independent 16-byte loads in flight) and the column metadata (births,
// sizes, active) once for the 8 rows, keeps a per-row running minimum with
// ic::take and its column, and each row is reduced across the block with
// redux.sync on the packed key. Each block leaves the minimum over its 32
// rows; the last block reduces the n / 32 partials.
//
// What bounds it on this card: a full scan reads every active row of D
// once (64 MiB at n = 4096, more than the 50 MB L2), so it is bound by
// device-memory bytes. A cached call writes row and column sa and reads
// the rescanned rows (about 2 to 4 rows of 16 KiB on normal data at
// n = 4096; counted in ctl[RESCANS..]), the cache and the metadata: some
// 200 KiB, which takes the card well under a microsecond, so the launch and
// the serial chain of dependent loads inside it (metadata, cache, a row,
// the partials, the bookkeeping) bound it. Under heavy ties many rows point
// at one column; a call then rescans many rows, never more than one full
// scan. There is no arithmetic on D: only `<` / `==` compares and selects,
// so results are bit-identical to the plain PyTorch twin. Built with
// -fmad=false like every kernel of the port.

#include "cache_key.cuh"

namespace {

using namespace ic;  // the cache's key (cache_key.cuh) and ic::kBig

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;  // warp 0 has a lane per row
constexpr int kBatch = 8;          // rows scanned together by the block

// ctl: int32 fields shared with ops/merge_kernels.py (CTL_*).
enum Ctl {
  kSa = 0,        // pending slot of the next call's update
  kDo = 1,        // the next call applies it
  kCounter = 2,   // next birth stamp
  kStep = 3,      // merges performed: the next log row
  kLimit = 4,     // most merges the loop may perform
  kFilled = 5,    // the cache holds every active row's minimum
  kTicket = 6,    // blocks finished in this call; the last one resets it
  kRescans = 7,   // rows rescanned in this call (reset by the last block)
  kRescanTotal = 8,  // rows rescanned by every cached call so far
  kRescanMax = 9,    // most rows rescanned by one cached call
};

struct Args {
  float* D;
  const float* dvec;
  int32_t* births;
  int32_t* sizes;
  int32_t* active;
  int32_t* ctl;
  int n;
  int max_size;
  // workspace
  u64* row_key;
  uint32_t* row_lo;
  int32_t* row_col;
  u64* part_key;
  uint32_t* part_lo;
  int32_t* part_row;
  int32_t* part_col;
  // outputs of every call
  float* out_d;
  int32_t* out_pair;
  // loop calls only (null otherwise)
  int32_t* log;
  long long* pair;
  float* pair_f;
  uint8_t* found;
};

struct Shared {
  u64 key[kRowsPerBlock];  // this block's rows, as the call leaves them
  uint32_t lo[kRowsPerBlock];
  int32_t col[kRowsPerBlock];
  int32_t list[kRowsPerBlock];  // rows to scan in full
  int32_t n_list;
  u64 red_key[kBatch][kWarps];  // per-row, per-warp minima of a batch
  uint32_t red_lo[kBatch][kWarps];
  int32_t red_col[kBatch][kWarps];
  bool last;
};

// Scans rows list[0..nb) (nb <= kBatch) in full with the whole block and
// leaves each row's minimum in the block's row slots and the cache.
__device__ __forceinline__ void scan_batch(const Args& a, const int32_t* list, const int nb,
                                           const int row0, Shared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int r[kBatch];
  int32_t b_r[kBatch], s_r[kBatch];
  ic::Best best[kBatch];
  int col[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    r[i] = i < nb ? list[i] : 0;
    b_r[i] = a.births[r[i]];
    s_r[i] = a.sizes[r[i]];
    best[i] = ic::identity();
    col[i] = kNone;
  }
  const int groups = a.n >> 2;
  for (int g = tid; g < groups; g += kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < nb) v[i] = reinterpret_cast<const float4*>(a.D + static_cast<size_t>(r[i]) * a.n)[g];
    }
    const int4 bc = reinterpret_cast<const int4*>(a.births)[g];
    const int4 sc = reinterpret_cast<const int4*>(a.sizes)[g];
    const int4 ac = reinterpret_cast<const int4*>(a.active)[g];
    const int c0 = g << 2;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i >= nb) continue;
      const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const int32_t bb[4] = {bc.x, bc.y, bc.z, bc.w};
      const int32_t ss[4] = {sc.x, sc.y, sc.z, sc.w};
      const int32_t aa[4] = {ac.x, ac.y, ac.z, ac.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + k;
        if (aa[k] > 0 && c != r[i] && s_r[i] + ss[k] <= a.max_size) {
          take_at(best[i], col[i], x[k], max(b_r[i], bb[k]), min(b_r[i], bb[k]), c);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (i >= nb) continue;  // uniform across the block
    Key key = to_key(best[i], col[i]);
    int c = col[i], unused = 0;
    warp_min(key, c, unused);
    if (lane == 0) {
      sh.red_key[i][warp] = key.k;
      sh.red_lo[i][warp] = key.lo;
      sh.red_col[i][warp] = c;
    }
  }
  __syncthreads();
  if (warp < nb) {
    Key key = no_key();
    int c = kNone, unused = 0;
    if (lane < kWarps) {
      key = Key{sh.red_key[warp][lane], sh.red_lo[warp][lane]};
      c = sh.red_col[warp][lane];
    }
    warp_min(key, c, unused);
    if (lane == 0) {
      const int row = list[warp];
      const int local = row - row0;
      sh.key[local] = key.k;
      sh.lo[local] = key.lo;
      sh.col[local] = c;
      a.row_key[row] = key.k;
      a.row_lo[row] = key.lo;
      a.row_col[row] = c;
    }
  }
  __syncthreads();  // the staging arrays are free for the next batch
}

// The last block: the pair from the partials, the outputs, the bookkeeping.
__device__ __forceinline__ void finish(const Args& a, const bool cached, Shared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.n / kRowsPerBlock;
  Key key = no_key();
  int row = kNone, col = kNone;
  for (int i = tid; i < G; i += kThreads) {
    const Key k{__ldcg(a.part_key + i), __ldcg(a.part_lo + i)};
    if (less(k, key)) {
      key = k;
      row = __ldcg(a.part_row + i);
      col = __ldcg(a.part_col + i);
    }
  }
  warp_min(key, row, col);
  if (lane == 0) {
    sh.red_key[0][warp] = key.k;
    sh.red_lo[0][warp] = key.lo;
    sh.red_col[0][warp] = row;
    sh.red_col[1][warp] = col;
  }
  __syncthreads();
  if (warp != 0) return;
  key = no_key();
  row = col = kNone;
  if (lane < kWarps) {
    key = Key{sh.red_key[0][lane], sh.red_lo[0][lane]};
    row = sh.red_col[0][lane];
    col = sh.red_col[1][lane];
  }
  warp_min(key, row, col);
  if (lane != 0) return;

  int32_t* ctl = a.ctl;
  const bool any = key.k != kNoKey;
  const float d = any ? dvalue(static_cast<uint32_t>(key.k >> 32)) : CUDART_INF_F;
  const int32_t hi = any ? bvalue(static_cast<uint32_t>(key.k)) : kBig;
  const int32_t lo = any ? bvalue(key.lo) : kBig;
  *a.out_d = d;
  a.out_pair[0] = hi;
  a.out_pair[1] = lo;
  if (a.log != nullptr) {
    const int32_t step = ctl[kStep];
    const bool found = isfinite(d) && step < ctl[kLimit];
    int32_t sa = 0, sb = 0, s_a = 0, s_b = 0;
    if (found) {
      const bool row_is_a = a.births[row] > a.births[col];
      sa = row_is_a ? row : col;
      sb = row_is_a ? col : row;
      s_a = a.sizes[sa];
      s_b = a.sizes[sb];
      const int32_t nb = ctl[kCounter];
      a.sizes[sa] = s_a + s_b;
      a.sizes[sb] = 0;
      a.active[sb] = 0;
      a.births[sa] = nb;
      int32_t* out = a.log + static_cast<size_t>(step) * 3;
      out[0] = hi;
      out[1] = lo;
      out[2] = nb;
      ctl[kCounter] = nb + 1;
      ctl[kStep] = step + 1;
    }
    ctl[kSa] = sa;
    ctl[kDo] = found ? 1 : 0;
    a.pair[0] = sa;
    a.pair[1] = sb;
    a.pair_f[0] = static_cast<float>(s_a);
    a.pair_f[1] = static_cast<float>(s_b);
    a.pair_f[2] = static_cast<float>(s_a + s_b);
    *a.found = found ? 1 : 0;
    ctl[kFilled] = 1;
    if (cached) {
      const int32_t rescans = atomicExch(ctl + kRescans, 0);
      ctl[kRescanTotal] += rescans;
      ctl[kRescanMax] = max(ctl[kRescanMax], rescans);
    }
  }
  ctl[kTicket] = 0;
}

__global__ void __launch_bounds__(kThreads) merge_update_argmin_kernel(const Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int sa = a.ctl[kSa];
  const bool upd = a.ctl[kDo] != 0;
  // without a loop the cache is scratch: always one full scan
  const bool cached = a.log != nullptr && a.ctl[kFilled] != 0;

  // 1. the pending update of this block's rows: row sa whole, column sa
  if (upd && sa >= row0 && sa < row0 + kRowsPerBlock) {
    float4* dst = reinterpret_cast<float4*>(a.D + static_cast<size_t>(sa) * n);
    for (int g = tid; g < (n >> 2); g += kThreads) {
      dst[g] = reinterpret_cast<const float4*>(a.dvec)[g];
    }
  }
  if (warp == 0) {
    const int r = row0 + lane;
    if (upd && r != sa) a.D[static_cast<size_t>(r) * n + sa] = a.dvec[r];
    // 2. which rows to scan in full; the others fold in column sa
    bool scan = false;
    Key key = no_key();
    int col = kNone;
    if (a.active[r] > 0) {
      if (!cached) {
        scan = true;
      } else {
        key = Key{a.row_key[r], a.row_lo[r]};
        col = a.row_col[r];
        if (upd) {
          if (r == sa || col == sa || (col != kNone && a.active[col] <= 0)) {
            scan = true;
          } else {
            const float dv = a.dvec[r];
            const int32_t b_r = a.births[r];
            const int32_t b_a = a.births[sa];
            if (a.sizes[r] + a.sizes[sa] <= a.max_size && !isnan(dv)) {
              const Key cand{(static_cast<u64>(dcode(dv)) << 32) | bcode(max(b_r, b_a)),
                             bcode(min(b_r, b_a))};
              if (less(cand, key)) {
                key = cand;
                col = sa;
                a.row_key[r] = cand.k;
                a.row_lo[r] = cand.lo;
                a.row_col[r] = sa;
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
      if (cached && mask != 0u) atomicAdd(a.ctl + kRescans, __popc(mask));
    }
  }
  __syncthreads();  // column and row sa written, the list whole

  // 3. the full scans
  const int n_list = sh.n_list;
  for (int b0 = 0; b0 < n_list; b0 += kBatch) {
    scan_batch(a, sh.list + b0, min(kBatch, n_list - b0), row0, sh);
  }

  // 4. this block's minimum, then the ticket
  if (warp == 0) {
    Key key{sh.key[lane], sh.lo[lane]};
    int row = row0 + lane, col = sh.col[lane];
    warp_min(key, row, col);
    if (lane == 0) {
      a.part_key[blockIdx.x] = key.k;
      a.part_lo[blockIdx.x] = key.lo;
      a.part_row[blockIdx.x] = row;
      a.part_col[blockIdx.x] = col;
      __threadfence();
      sh.last = atomicAdd(a.ctl + kTicket, 1) == static_cast<int>(gridDim.x) - 1;
    }
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  finish(a, cached, sh);
}

}  // namespace

extern "C" {

const char* ic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of the workspace for n rows: the cache (16 bytes a row) and the
// per-block partials (20 bytes a block).
long long ic_merge_workspace_bytes(int n) {
  const long long G = n / kRowsPerBlock;
  return 16LL * n + 20LL * G;
}

// All pointers are device pointers. D (n, n) f32, dvec (n,) f32, births,
// sizes, active (n,) int32, ctl (>= 10,) int32 (CTL_* in
// ops/merge_kernels.py; ctl[kSa], ctl[kDo] hold the pending update,
// ctl[kTicket] must be 0), ws the workspace (ic_merge_workspace_bytes),
// out_d one f32, out_pair two int32. A loop call passes log (n - 1, 3)
// int32, pair (2,) int64, pair_f (3,) f32 and found (1,) uint8; a call
// without a loop passes null for all four, and only D and the outputs
// change. n % 128 == 0. Returns the cudaError_t of the launch (0 on
// success).
int ic_merge_update_argmin(void* D, const void* dvec, void* births, void* sizes, void* active,
                           void* ctl, int n, int max_size, void* ws, void* out_d,
                           void* out_pair, void* log, void* pair, void* pair_f, void* found,
                           void* stream) {
  const int G = n / kRowsPerBlock;
  char* w = static_cast<char*>(ws);
  Args a;
  a.D = static_cast<float*>(D);
  a.dvec = static_cast<const float*>(dvec);
  a.births = static_cast<int32_t*>(births);
  a.sizes = static_cast<int32_t*>(sizes);
  a.active = static_cast<int32_t*>(active);
  a.ctl = static_cast<int32_t*>(ctl);
  a.n = n;
  a.max_size = max_size;
  a.row_key = reinterpret_cast<u64*>(w);
  a.row_lo = reinterpret_cast<uint32_t*>(w + 8LL * n);
  a.row_col = reinterpret_cast<int32_t*>(w + 12LL * n);
  a.part_key = reinterpret_cast<u64*>(w + 16LL * n);
  a.part_lo = reinterpret_cast<uint32_t*>(w + 16LL * n + 8LL * G);
  a.part_row = reinterpret_cast<int32_t*>(w + 16LL * n + 12LL * G);
  a.part_col = reinterpret_cast<int32_t*>(w + 16LL * n + 16LL * G);
  a.out_d = static_cast<float*>(out_d);
  a.out_pair = static_cast<int32_t*>(out_pair);
  a.log = static_cast<int32_t*>(log);
  a.pair = static_cast<long long*>(pair);
  a.pair_f = static_cast<float*>(pair_f);
  a.found = static_cast<uint8_t*>(found);
  merge_update_argmin_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
