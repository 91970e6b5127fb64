// Kernel K3: the voxel map's sorted-key lookup, in three modes of one source.
//
// Replaces the TPU kernel scripts/pallas_search_exp.py (make_search(...).search
// -> kernel), a lower-bound binary search of int32 queries in a sorted int32
// key table, and the work around it in voxel_map.gather_candidates and
// voxel_map._update_impl. The keys are sorted ascending and may hold runs of
// equal keys (the map's EMPTY_KEY tail); the lower bound of a run is returned,
// never another element of it. The modes:
//
// - bare search (search_sorted_launch): for each query q in any order, the
//   number of keys strictly less than q, i.e. searchsorted(keys, q,
//   side="left").
// - neighbourhood lookup (neighborhood_launch), one thread per (column, query)
//   of the (9, Q) column-major layout: the query's world point
//   ((p0 R[i,0] + p1 R[i,1]) + p2 R[i,2]) + t[i] (se3.rot_pts's order, each
//   operation rounded on its own), its voxel index by an IEEE division and
//   truncation toward zero, the column's window test and start key, the
//   search, the clamp, the three z probes, base and n_present (all as
//   voxel_map._neighborhood_slots); then the present slices' search lanes
//   [0, RW) are copied from the table into the candidate rows. Rows of absent
//   slices (s >= n_present) are not written: the CandidateSet contract masks
//   them and kernel K1 never reads them.
// - group lookup (group_launch): map_update's lookup of its sorted incoming
//   keys in the shifted table, pos_c = min(lower bound, C - 1) and
//   found = (q != EMPTY_KEY) & (keys[pos_c] == q).
//
// Lanes: the neighbourhood and group lookups serve B independent maps in one
// launch. Every per-sequence input and output gains a leading B (keys
// (B, C), tab (B, C, W), origin (B, 3), the pose (B, 3, 3) / (B, 3), the
// queries (B, Q, 3) or (B, N), ...), the lane is the grid's second
// dimension, and a lane's result is bitwise the B = 1 launch's. The group
// lookup's queries are sorted within each lane. The bare search keeps its
// one table.
//
// Bound on Hopper: device-memory bytes for the neighbourhood lookup (each
// present slice's 256-byte row read and written, ~17 MB on the bench drive's
// map at Q = 8192), and the latency of dependent loads for the searches: the
// 512 KB table stays in the 50 MB L2, each query and output moves 4-9 bytes,
// and one search is ceil(log2(C + 1)) = 18 loads that each wait on the last.
//
// Design. The search is one thread per query walking the table with a
// guarded binary search: the step count is the same for every thread and the
// guard is a select, so a warp never diverges, and neighbouring queries share
// the top of the walk through L1. Staging splitters (every S-th key) in
// shared memory so that a search ends in a line of global keys was measured
// slower on the H100 at the path's shapes except for map_update's sorted
// queries (PERF.md): every block has to fetch hundreds of scattered sectors
// first. The neighbourhood lookup loads its column's three probe keys at
// once. Its row copy is done by whole warps: a warp prefix sum numbers the
// lanes' present rows into a per-warp list in shared memory, then 16-byte
// loads and stores move them, kCopyUnroll loads in flight per lane. The copy
// is ~8 of the lookup's ~14 microseconds on the bench drive's map.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyKey = 0x7FFFFFFF;
// key packing and map window of ops/voxel_map.py: x [20..30], y [9..19], z [0..8]
constexpr int kYB = 11, kZB = 9;
constexpr int kXOff = 1 << 10, kYOff = 1 << 10, kZOff = 1 << 8;
constexpr int kGHalf = 512, kDirZHalf = 128, kDirZLo = kZOff - kDirZHalf;
constexpr int kRowsPerWarp = 3 * 32;  // at most three present slices a lane
constexpr int kCopyUnroll = 8;  // 4 measured slower; 16 would cost occupancy

struct Table {
  const int* keys;
  int C;
  int steps;  // ceil(log2(C + 1))
};

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32 wrap, as torch's
  return (int)((unsigned)a + (unsigned)b);
}

// The number of keys strictly less than q: a guarded binary walk (a
// finished query stays where it is; without the guard a query above every
// key would step past C).
__device__ int lower_bound(const Table& t, int q) {
  int lo = 0, hi = t.C;
  for (int s = 0; s < t.steps; ++s) {
    const int mid = (lo + hi) >> 1;  // no overflow while C < 2^30
    const bool less = __ldg(t.keys + min(mid, t.C - 1)) < q;
    const bool active = lo < hi;
    lo = (active && less) ? mid + 1 : lo;
    hi = (active && !less) ? mid : hi;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
search_kernel(Table t, const int* __restrict__ queries, int N, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) out[i] = lower_bound(t, queries[i]);
}

__global__ void __launch_bounds__(kThreads)
group_kernel(Table t, const int* __restrict__ queries, int N, int* __restrict__ pos_c,
             unsigned char* __restrict__ found) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const long long b = blockIdx.y;  // the lane: its table, queries and outputs
  t.keys += b * t.C;
  queries += b * N;
  pos_c += b * N;
  found += b * N;
  const int q = queries[i];
  const int p = min(lower_bound(t, q), t.C - 1);
  pos_c[i] = p;
  found[i] = q != kEmptyKey && __ldg(t.keys + p) == q;
}

struct Neighborhood {
  const int* tab;  // (C, W) map rows
  int W, RW;
  const int* origin;  // (3,)
  const float* query;  // (Q, 3) local points
  const unsigned char* valid;  // (Q,)
  const float* R;  // (3, 3)
  const float* t;  // (3,)
  float voxel_size;
  int Q;
  int* base;  // (9, Q)
  int* n_present;  // (9, Q)
  int* rows0;  // three (9 Q, RW)
  int* rows1;
  int* rows2;
};

__global__ void __launch_bounds__(kThreads)
neighborhood_kernel(Table t, Neighborhood a) {
  __shared__ int2 lists[kWarps][kRowsPerWarp];
  const int lane = threadIdx.x & 31;
  int2* list = lists[threadIdx.x >> 5];
  {  // the block's sequence (grid y): its map, queries, pose and outputs
    const long long b = blockIdx.y;
    t.keys += b * t.C;
    a.tab += b * t.C * a.W;
    a.origin += b * 3;
    a.query += b * 3 * a.Q;
    a.valid += b * a.Q;
    a.R += b * 9;
    a.t += b * 3;
    a.base += b * 9 * a.Q;
    a.n_present += b * 9 * a.Q;
    a.rows0 += b * 9 * a.Q * a.RW;
    a.rows1 += b * 9 * a.Q * a.RW;
    a.rows2 += b * 9 * a.Q * a.RW;
  }

  // (1) the column's slots. No thread returns early: the whole warp copies.
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int base = t.C - 1, n = 0;
  if (j < 9 * a.Q) {
    const int c = j / a.Q, q = j - c * a.Q;
    const float x = a.query[3 * q], y = a.query[3 * q + 1], z = a.query[3 * q + 2];
    int rel[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float w = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, a.R[3 * i]),
                                                    __fmul_rn(y, a.R[3 * i + 1])),
                                          __fmul_rn(z, a.R[3 * i + 2])),
                                a.t[i]);
      rel[i] = wrap_add(__float2int_rz(__fdiv_rn(w, a.voxel_size)), -a.origin[i]);
    }
    // _COLUMN_OFFSETS order: c = 3 (dx + 1) + (dy + 1)
    const int rx = wrap_add(rel[0], c / 3 - 1 + kXOff);
    const int ry = wrap_add(rel[1], c % 3 - 1 + kYOff);
    const int zd = wrap_add(rel[2], kDirZHalf);
    const bool col_ok = a.valid[q] != 0 && rx >= kXOff - kGHalf && rx < kXOff + kGHalf &&
                        ry >= kYOff - kGHalf && ry < kYOff + kGHalf;
    if (col_ok) {
      const int col = (rx << (kYB + kZB)) | (ry << kZB);
      const int start = col | (min(max(wrap_add(zd, -1), 0), 2 * kDirZHalf - 1) + kDirZLo);
      base = min(lower_bound(t, start), t.C - 1);
      // the three probes at once; slots past the table read as EMPTY_KEY
      int probe[3];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        probe[s] = base + s < t.C ? __ldg(t.keys + base + s) : kEmptyKey;
      int slot = 0;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int zz = wrap_add(zd, dz);
        const int key = col | (min(max(zz, 0), 2 * kDirZHalf - 1) + kDirZLo);
        const int at = slot == 0 ? probe[0] : slot == 1 ? probe[1] : probe[2];
        const int here = zz >= 0 && zz < 2 * kDirZHalf && at == key;
        n += here;
        slot += here;
      }
    }
    a.base[j] = base;
    a.n_present[j] = n;
  }

  // (2) the present rows, numbered by a warp prefix sum into the warp's list
  // as (table slot, destination row j * 4 + s)
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  for (int s = 0; s < n; ++s) list[incl - n + s] = make_int2(base + s, j * 4 + s);
  __syncwarp();
  const int cpr = a.RW >> 2;  // 16-byte chunks per row
  const int w4 = a.W >> 2;
  const int n_chunks = total * cpr;
  const int4* tab4 = reinterpret_cast<const int4*>(a.tab);
  for (int u0 = 0; u0 < n_chunks; u0 += 32 * kCopyUnroll) {
    int4 v[kCopyUnroll];
    int dst[kCopyUnroll], ch[kCopyUnroll];
#pragma unroll
    for (int b = 0; b < kCopyUnroll; ++b) {
      const int u = u0 + 32 * b + lane;
      dst[b] = -1;
      if (u < n_chunks) {
        const int r = u / cpr;
        const int2 e = list[r];
        ch[b] = u - r * cpr;
        dst[b] = e.y;
        v[b] = __ldg(tab4 + (long long)e.x * w4 + ch[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kCopyUnroll; ++b) {
      if (dst[b] < 0) continue;
      const int s = dst[b] & 3;
      int* rows = s == 0 ? a.rows0 : s == 1 ? a.rows1 : a.rows2;
      reinterpret_cast<int4*>(rows)[(long long)(dst[b] >> 2) * cpr + ch[b]] = v[b];
    }
  }
}

Table make_table(const void* keys, int C) {
  Table t{(const int*)keys, C, 0};
  while ((1LL << t.steps) <= (long long)C) ++t.steps;  // ceil(log2(C + 1))
  return t;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int search_sorted_launch(const void* keys, int C, const void* queries, int N,
                                    void* out, void* stream) {
  if (N == 0) return 0;  // a zero-block grid is a launch error
  search_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      make_table(keys, C), (const int*)queries, N, (int*)out);
  return (int)cudaGetLastError();
}

// B lanes: keys (B, C), queries, pos_c and found (B, N).
extern "C" int group_lookup_launch(const void* keys, int C, const void* queries, int B,
                                   int N, void* pos_c, void* found, void* stream) {
  if (N == 0 || B == 0) return 0;
  group_kernel<<<dim3(blocks_for(N), B), kThreads, 0, (cudaStream_t)stream>>>(
      make_table(keys, C), (const int*)queries, N, (int*)pos_c, (unsigned char*)found);
  return (int)cudaGetLastError();
}

// One launch writes base, n_present and the present rows of the CandidateSets
// of B lanes.
extern "C" int neighborhood_launch(const void* tab, int C, int W, int RW, const void* keys,
                                   const void* origin, const void* query, const void* valid,
                                   int B, int Q, const void* R, const void* t,
                                   float voxel_size, void* base, void* n_present, void* rows0,
                                   void* rows1, void* rows2, void* stream) {
  if (Q == 0 || B == 0) return 0;
  const Neighborhood a{(const int*)tab, W, RW, (const int*)origin, (const float*)query,
                       (const unsigned char*)valid, (const float*)R, (const float*)t,
                       voxel_size, Q, (int*)base, (int*)n_present, (int*)rows0,
                       (int*)rows1, (int*)rows2};
  neighborhood_kernel<<<dim3(blocks_for(9LL * Q), B), kThreads, 0, (cudaStream_t)stream>>>(
      make_table(keys, C), a);
  return (int)cudaGetLastError();
}
