// Whole per-bucket Lance-Williams merge loop for Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_loop_whole (kernel
// body _whole_loop_kernel, :354-487). One block runs one bucket's complete
// constrained-Ward merge loop, the TPU grid step's work:
//   * main phase: at most B - 1 trips, each while the last trip found a pair
//     and num_active > target;
//   * absorb phase (absorb_min > 0 only): `found` is reset to 1, then at most
//     B - 1 trips while the last trip found a pair and an active cluster is
//     under absorb_min; only pairs with an under-min side are feasible.
// Each trip takes the feasible pair with the smallest Ward distance (ties:
// smallest (max birth, min birth), the Go scan order), merges it with the
// Lance-Williams recurrence, writes its log row (bhi, blo, new birth) and
// updates sizes, births and active. Outputs: log (C, B - 1, 3), step (C,),
// births, sizes, active (C, B), all int32.
//
// The TPU kernel keeps the (B, B) matrix in VMEM and rescans all of it every
// trip. A block here has at most 227 KB of shared memory and the default
// bucket (B = 512) is 1 MiB of f32, so the matrix stays in DEVICE memory (the
// caller's (C, B, B) temporary, updated in place) and the block keeps, in
// shared memory, a cache of each active row's minimum instead:
//   best_key[r], best_col[r]: the minimum over the feasible columns c of row
//   r of ic::take's (d, max birth, min birth) order, packed into one 64-bit
//   key, and that c (-1: none);
// beside (birth, size) per slot (a slot is active iff its size is > 0, as in
// the twin), dvec, a queue of rows to rescan and two trip stamps per slot.
//
// One full scan fills the cache at the start of each phase (the absorb
// phase's mask changes every row's feasible set); each warp leaves the
// minimum over its rows. Then each trip, with two barriers:
//   1. every warp reduces the per-warp minima: the key's row and column are
//      the pair, sa the slot with the larger birth, sb the other;
//   2. dvec from rows sa and sb (device memory) with the expression tree of
//      pallas_kernels.py:440-443, ((s_a + sz) * d_a + (s_b + sz) * d_b -
//      sz * d_ab) / (s_new + sz), each operation rounded once (the library
//      is built with -fmad=false, IEEE division and no flush to zero); row
//      sa and every other active row whose cached column is sa or sb are
//      queued, and the latter prefetched into L2;
//   3. column sa, then row sa, are written to D; every other active row
//      folds in its one new candidate, dvec[r] at column sa, if feasible
//      under the new sizes; a warp per queued row rescans it in full (row
//      sa from dvec in shared memory, the others from D, seeing slots sa and
//      sb as the merge leaves them); row sb's entry is cleared; each warp
//      leaves its minimum, and thread 0 updates the slots and the log row.
// Why this is exact: a merge changes D only in row and column sa; it
// changes the feasibility (activity, size, under-min side) only of pairs
// that involve sa or sb, and the tie key only of pairs that involve sa,
// whose birth is new. Sizes and births of every other slot stay as they
// were. So a row whose minimum was at a column other than sa and sb keeps
// that minimum over its unchanged columns, and its new minimum is the
// lesser of it and the one changed entry, column sa. Rows sa and sb and the
// rows that pointed at them are recomputed. Like the Pallas body, the full
// B x B feasible set is searched (no triangle): D from a Gram product need
// not be bit-symmetric.
//
// D ends bit-identical to the twin's D, but a trip writes column sa only in
// the rows active before it: no later trip reads an inactive row. The rows
// inactive at the end get the entries they missed from the transpose
// (fill_inactive_rows), once, with full rows read and written.
//
// What bounds it on this card: the chain of serial trips (about 300 merges
// a bucket at 384 items), and the column writes. A trip reads rows sa and
// sb and the rescanned rows other than sa (about 6 on normal data): some
// 16 KiB at B = 512, where a full rescan read every active row, about
// 480 KiB. It writes row sa whole, but column sa as one 4-byte store per
// row: each a partial 32-byte sector, which the card's memory merges by
// reading it. Writing every row's, as the twin does, took as long as all
// the rest of the kernel; tools/k2_variants.py times both. With C blocks
// of 512 threads, two per SM, a chunk of 256 buckets runs in one wave.
// Under heavy ties many rows may point at sa or sb; a trip then costs up
// to one full scan, never more.

#include "lexmin.cuh"

namespace {

using ic::kBig;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 4096;      // 144 KB of shared memory
constexpr int kUnroll = 16;      // loads in flight per lane in a row scan
constexpr int kNone = -1;        // column of a row with no feasible pair
constexpr int kBirthBits = 13;   // an active slot's birth is < 2 B <= 8192
constexpr uint64_t kNoKey = ~0ull;
constexpr uint32_t kFull = 0xffffffffu;  // every lane of a warp
constexpr int kTile = 32 * 33;    // floats of one warp's transpose tile

// The lexicographic (d, max birth, min birth) order of ic::take as one
// unsigned 64-bit key: d's bits mapped to an order-preserving code (-0 onto
// +0, which `==` finds equal), then the two births in 13 bits each. A NaN
// gets no key: take never takes one.
__device__ __forceinline__ uint64_t pack(float d, int32_t b1, int32_t b2) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t tie = (static_cast<uint32_t>(max(b1, b2)) << kBirthBits) |
                       static_cast<uint32_t>(min(b1, b2));
  return (static_cast<uint64_t>(u) << 32) | tie;
}

// d of a key (kNoKey gives a NaN).
__device__ __forceinline__ float key_d(uint64_t key) {
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Warp minimum of (key, at), in every lane; among equal keys, the lowest
// lane's `at`.
__device__ __forceinline__ void warp_min(uint64_t& key, int& at) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t m_hi = __reduce_min_sync(kFull, hi);
  const uint32_t m_lo = __reduce_min_sync(kFull, hi == m_hi ? lo : kFull);
  const uint32_t won = __ballot_sync(kFull, hi == m_hi && lo == m_lo);
  at = __shfl_sync(kFull, at, __ffs(won) - 1);
  key = (static_cast<uint64_t>(m_hi) << 32) | m_lo;
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

struct Shared {
  uint64_t part_key[kWarps];  // per-warp minima over the cache
  int32_t part_row[kWarps];
  int32_t counter;            // next birth stamp
  int32_t num_active;
  int32_t step;               // merges performed
  int32_t n_queued[2];        // rows to rescan, by the parity of step
};

struct Bucket {
  float* D;            // (B, B), this bucket's matrix
  int B;
  int max_size;
  int amin;
  uint64_t* best_key;  // shared, B each: the cache
  int32_t* best_col;
  int2* slot;          // (birth, size); active iff size > 0
  int32_t* t_sa;       // the last trip that merged into the slot, -1: none
  int32_t* t_out;      // the trip that retired the slot; -1: never active
  float* dv;
  int32_t* queue;
  int32_t* log;        // (B - 1, 3)
};

// The merge a rescan sees: slot sa holds (nb, s_new) and sb is inactive,
// whether or not thread 0 has written them yet. No merge: sa = sb = kNone.
struct Merge {
  int sa;
  int sb;
  int32_t nb;
  int32_t s_new;
};

// Warp-cooperative: row r's minimum key over its feasible columns, and the
// column, in every lane. `vals` is the row (device memory, or dv for row
// sa); `own` is r's (birth, size) and dv_r its new entry in column m.sa.
__device__ __forceinline__ void scan_row(const Bucket& k, const float* vals, const int r,
                                         const int2 own, const float dv_r, const Merge& m,
                                         const bool use_amin, uint64_t& key, int& col) {
  const int lane = threadIdx.x & 31;
  const bool under_r = own.y < k.amin;
  key = kNoKey;
  col = kNone;
  for (int c0 = lane; c0 < k.B; c0 += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      v[u] = (c < k.B && c != m.sa) ? vals[c] : dv_r;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      if (c >= k.B || c == r || c == m.sb || isnan(v[u])) continue;
      const int2 sc = c == m.sa ? make_int2(m.nb, m.s_new) : k.slot[c];
      if (sc.y <= 0 || own.y + sc.y > k.max_size) continue;
      if (use_amin && !(under_r || sc.y < k.amin)) continue;
      const uint64_t kc = pack(v[u], own.x, sc.x);
      if (kc < key) {
        key = kc;
        col = c;
      }
    }
  }
  warp_min(key, col);
}

// The cache of every row and the per-warp minima, at the start of a phase.
__device__ __forceinline__ void full_scan(const Bucket& k, const bool use_amin, Shared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Merge none{kNone, kNone, 0, 0};
  uint64_t part = kNoKey;
  int part_row = kNone;
  for (int r = warp; r < k.B; r += kWarps) {
    const int2 own = k.slot[r];
    uint64_t key = kNoKey;
    int col = kNone;
    if (own.y > 0) scan_row(k, k.D + static_cast<size_t>(r) * k.B, r, own, 0.f, none, use_amin, key, col);
    if (lane == 0) {
      k.best_key[r] = key;
      k.best_col[r] = col;
    }
    if (key < part) {
      part = key;
      part_row = r;
    }
  }
  if (lane == 0) {
    sh.part_key[warp] = part;
    sh.part_row[warp] = part_row;
  }
  if (threadIdx.x == 0) sh.n_queued[0] = sh.n_queued[1] = 0;
  __syncthreads();
}

// One trip: find the pair; if there is one, merge it, bring the cache up to
// date and leave the per-warp minima for the next trip. Every thread of the
// block calls it; returns `found` (the same in every thread).
__device__ __forceinline__ bool merge_once(const Bucket& k, const bool use_amin, Shared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int B = k.B;

  // 1. the pair: every warp reduces the per-warp minima itself
  uint64_t key = lane < kWarps ? sh.part_key[lane] : kNoKey;
  int r0 = lane < kWarps ? sh.part_row[lane] : kNone;
  warp_min(key, r0);
  if (!isfinite(key_d(key))) return false;
  const int c0 = k.best_col[r0];
  const int2 slot_r = k.slot[r0];
  const int2 slot_c = k.slot[c0];
  const bool row_is_a = slot_r.x > slot_c.x;
  const int2 slot_a = row_is_a ? slot_r : slot_c;
  const int2 slot_b = row_is_a ? slot_c : slot_r;
  Merge m;
  m.sa = row_is_a ? r0 : c0;
  m.sb = row_is_a ? c0 : r0;
  m.nb = sh.counter;
  m.s_new = slot_a.y + slot_b.y;
  const int q = sh.step & 1;

  // 2. dvec from rows sa and sb; queue row sa and the rows whose cached
  // column is sa or sb, and bring the latter into L2
  const float sa_f = static_cast<float>(slot_a.y);
  const float sb_f = static_cast<float>(slot_b.y);
  const float sn_f = static_cast<float>(m.s_new);
  const float* row_a = k.D + static_cast<size_t>(m.sa) * B;
  const float* row_b = k.D + static_cast<size_t>(m.sb) * B;
  const float d_ab = row_a[m.sb];
  uint32_t was_active = 0;  // bit i: slot tid + i * kThreads, before this merge
  for (int i = 0, j = tid; j < B; ++i, j += kThreads) {
    const int2 sj = k.slot[j];
    if (sj.y > 0) was_active |= 1u << i;
    float v = 0.f;
    if (j != m.sa) {
      const float sz = static_cast<float>(sj.y);
      const float t_a = (sa_f + sz) * row_a[j];
      const float t_b = (sb_f + sz) * row_b[j];
      const float t_ab = sz * d_ab;
      v = ((t_a + t_b) - t_ab) / (sn_f + sz);
    }
    k.dv[j] = v;
    const int cj = k.best_col[j];
    if (j == m.sa) {
      k.queue[atomicAdd(&sh.n_queued[q], 1)] = j;
    } else if (j != m.sb && sj.y > 0 && (cj == m.sa || cj == m.sb)) {
      k.queue[atomicAdd(&sh.n_queued[q], 1)] = j;
      const float* row = k.D + static_cast<size_t>(j) * B;
      for (int o = 0; o < B; o += 32) prefetch_l2(row + o);
    }
  }
  __syncthreads();  // dv and the queue are whole; rows sa and sb are read before either is written

  // 3. column sa (in the rows active before the merge), then row sa; fold
  // column sa's new entry into every other row's cache; rescan the queued
  // rows; the per-warp minima. Thread 0 writes slots sa and sb, which no
  // other thread reads here (Merge).
  for (int i = 0, j = tid; j < B; ++i, j += kThreads) {
    const float v = k.dv[j];
    if ((was_active >> i) & 1u) k.D[static_cast<size_t>(j) * B + m.sa] = v;
    k.D[static_cast<size_t>(m.sa) * B + j] = v;
  }
  uint64_t part = kNoKey;
  int part_row = kNone;
  for (int r = tid; r < B; r += kThreads) {
    if (r == m.sb) {
      k.best_key[r] = kNoKey;
      k.best_col[r] = kNone;
      continue;
    }
    if (r == m.sa) continue;
    const int2 sr = k.slot[r];
    if (sr.y <= 0) continue;
    const int c = k.best_col[r];
    if (c == m.sa || c == m.sb) continue;
    uint64_t kr = k.best_key[r];
    const float d = k.dv[r];
    if (sr.y + m.s_new <= k.max_size && (!use_amin || sr.y < k.amin || m.s_new < k.amin) &&
        !isnan(d)) {
      const uint64_t cand = pack(d, sr.x, m.nb);
      if (cand < kr) {
        kr = cand;
        k.best_key[r] = cand;
        k.best_col[r] = m.sa;
      }
    }
    if (kr < part) {
      part = kr;
      part_row = r;
    }
  }
  warp_min(part, part_row);
  const int n = sh.n_queued[q];
  for (int i = warp; i < n; i += kWarps) {
    const int r = k.queue[i];
    uint64_t kr;
    int col;
    if (r == m.sa) {
      scan_row(k, k.dv, r, make_int2(m.nb, m.s_new), 0.f, m, use_amin, kr, col);
    } else {
      scan_row(k, k.D + static_cast<size_t>(r) * B, r, k.slot[r], k.dv[r], m, use_amin, kr, col);
    }
    if (lane == 0) {
      k.best_key[r] = kr;
      k.best_col[r] = col;
    }
    if (kr < part) {
      part = kr;
      part_row = r;
    }
  }
  if (lane == 0) {
    sh.part_key[warp] = part;
    sh.part_row[warp] = part_row;
  }
  if (tid == 0) {
    k.slot[m.sa] = make_int2(m.nb, m.s_new);
    k.slot[m.sb] = make_int2(slot_b.x, 0);
    k.t_sa[m.sa] = sh.step;
    k.t_out[m.sb] = sh.step;
    const uint32_t tie = static_cast<uint32_t>(key);
    int32_t* row = k.log + static_cast<size_t>(sh.step) * 3;
    row[0] = static_cast<int32_t>(tie >> kBirthBits);
    row[1] = static_cast<int32_t>(tie & ((1u << kBirthBits) - 1));
    row[2] = m.nb;
    sh.counter = m.nb + 1;
    sh.num_active -= 1;
    sh.step += 1;
    sh.n_queued[q ^ 1] = 0;  // the next trip's queue
  }
  __syncthreads();
  return true;
}

// The column entries the trips left out: a trip writes column sa only in
// the rows active before it, and an inactive row is never read again. Row
// j, inactive at the end, took its last column write from slot c at trip
// t_sa[c] if t_sa[c] > t_out[j]; that write put dvec[j] into D[j][c], and
// row c's write of the same trip the same value into D[c][j], which no
// later trip changed (row c was not written again, column j never, as j
// was inactive). So D[j][c] = D[c][j] for those pairs, copied through a
// 32 x 32 tile per warp; no source of the copy is a target of it.
__device__ __forceinline__ void fill_inactive_rows(const Bucket& k, float* tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int B = k.B;
  const int nt = (B + 31) / 32;
  float* tile = tiles + warp * kTile;
  for (int t = warp; t < nt * nt; t += kWarps) {
    const int j0 = (t / nt) * 32;
    const int c0 = (t % nt) * 32;
    const int j = j0 + lane;
    const int c = c0 + lane;
    const int out = (j < B && k.slot[j].y == 0) ? k.t_out[j] : kBig;  // fix (j, c) iff t_sa[c] > out
    const int ts = c < B ? k.t_sa[c] : -1;
    const int lo = __reduce_min_sync(kFull, out);
    if (__reduce_max_sync(kFull, ts) <= lo) continue;  // nothing to fill in this tile
    for (int i = 0; i < 32; ++i) {  // tile[i][lane] = D[c0 + i][j]
      const int ts_i = __shfl_sync(kFull, ts, i);
      if (ts_i > lo && j < B) tile[i * 33 + lane] = k.D[static_cast<size_t>(c0 + i) * B + j];
    }
    __syncwarp();
    for (int i = 0; i < 32; ++i) {  // D[j0 + i][c] = D[c][j0 + i]
      const int out_i = __shfl_sync(kFull, out, i);
      if (ts > out_i && c < B) k.D[static_cast<size_t>(j0 + i) * B + c] = tile[lane * 33 + i];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
merge_loop_whole_kernel(float* D, const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ targets, int B, int max_size, int amin,
                        int32_t* __restrict__ log, int32_t* __restrict__ step_out,
                        int32_t* __restrict__ births_out, int32_t* __restrict__ sizes_out,
                        int32_t* __restrict__ active_out) {
  extern __shared__ uint64_t smem[];
  __shared__ Shared sh;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int cnt = counts[c];
  const int tgt = targets[c];
  const int n_log = B - 1;
  Bucket k;
  k.D = D + static_cast<size_t>(c) * B * B;
  k.B = B;
  k.max_size = max_size;
  k.amin = amin;
  k.slot = reinterpret_cast<int2*>(smem);
  k.t_sa = reinterpret_cast<int32_t*>(smem + B);
  k.t_out = k.t_sa + B;
  k.best_key = smem + 2 * B;  // from here on, the transpose tiles at the end
  k.best_col = reinterpret_cast<int32_t*>(smem + 3 * B);
  k.dv = reinterpret_cast<float*>(k.best_col + B);
  k.queue = k.best_col + 2 * B;
  k.log = log + static_cast<size_t>(c) * n_log * 3;

  for (int j = tid; j < B; j += kThreads) {
    const bool a = j < cnt;
    k.slot[j] = make_int2(a ? j : kBig - B + j, a ? 1 : 0);
    k.t_sa[j] = -1;
    k.t_out[j] = a ? kBig : -1;
  }
  for (int j = tid; j < n_log * 3; j += kThreads) k.log[j] = 0;
  if (tid == 0) {
    sh.counter = cnt;
    sh.num_active = cnt;
    sh.step = 0;
  }
  __syncthreads();

  bool found = true;
  for (int trip = 0; trip < B - 1; ++trip) {
    if (!(found && sh.num_active > tgt)) break;  // uniform: read after a barrier
    if (trip == 0) full_scan(k, false, sh);
    found = merge_once(k, false, sh);
  }
  __syncthreads();  // every thread has left the loop

  if (amin > 0) {
    found = true;
    for (int trip = 0; trip < B - 1; ++trip) {
      int under = 0;
      for (int j = tid; j < B; j += kThreads) {
        const int32_t s = k.slot[j].y;
        under |= (s > 0 && s < amin) ? 1 : 0;
      }
      const int has_under = __syncthreads_or(under);
      if (!(found && has_under)) break;
      if (trip == 0) full_scan(k, true, sh);
      found = merge_once(k, true, sh);
    }
    __syncthreads();
  }

  fill_inactive_rows(k, reinterpret_cast<float*>(smem + 2 * B));

  const size_t base = static_cast<size_t>(c) * B;
  for (int j = tid; j < B; j += kThreads) {
    const int2 s = k.slot[j];
    births_out[base + j] = s.x;
    sizes_out[base + j] = s.y;
    active_out[base + j] = s.y > 0 ? 1 : 0;
  }
  if (tid == 0) step_out[c] = sh.step;
}

}  // namespace

extern "C" {

// Largest bucket width the kernel takes (shared memory: 16 B bytes and the
// larger of 20 B bytes and 66 KB).
int ic_merge_loop_whole_max_b() { return kMaxB; }

// All pointers are device pointers. D is (C, B, B) f32, updated in place;
// counts and targets (C,) int32; log (C, B - 1, 3), step (C,), births,
// sizes, active (C, B) int32 outputs. 2 <= B <= kMaxB. Returns the
// cudaError_t of the launch (0 on success).
int ic_merge_loop_whole(void* D, const void* counts, const void* targets, int C, int B,
                        int max_size, int absorb_min, void* log, void* step, void* births,
                        void* sizes, void* active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cache = 5 * B * static_cast<int>(sizeof(int32_t));
  const int tiles = kWarps * kTile * static_cast<int>(sizeof(float));
  const int smem = 4 * B * static_cast<int>(sizeof(int32_t)) + (cache > tiles ? cache : tiles);
  cudaError_t err = cudaFuncSetAttribute(
      merge_loop_whole_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_loop_whole_kernel<<<C, kThreads, smem, s>>>(
      static_cast<float*>(D), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(targets), B, max_size, absorb_min,
      static_cast<int32_t*>(log), static_cast<int32_t*>(step),
      static_cast<int32_t*>(births), static_cast<int32_t*>(sizes),
      static_cast<int32_t*>(active));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
