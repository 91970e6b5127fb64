// The keyframe map's per-scan update: ops/voxel_map.py map_update (evict +
// rebase + insert) with the update points' world transform before it and
// the diagnostics after it, for every lane of a batch, in four launches
// around a library sort and K3's group lookup (kernels/map_update.py holds
// the plain version it is held to, bitwise: the whole (B, C, W) table, keys,
// count, origin, the map's size and the points dropped at the map window).
//
// Replaces no TPU kernel: the JAX package writes the update as array code
// (a stable sort of the C + N keys, a scatter into the extended rows, a
// C-row gather) and leaves it to XLA. The port's plain composition of the
// same code runs as ~280 PyTorch kernels a scan, among them two single-row
// scans (one block walking 16,384 elements, ~47 us each on the H100), a
// stable sort of C + N keys and two passes over an extended copy of the
// table.
//
// What it uses: both lists are sorted already. The live old rows keep their
// order when their keys shift uniformly to the new origin (a shift of under
// 512 voxels along x, which the map window's eviction makes every larger
// move moot), and the fresh voxels arrive sorted by the incoming stable
// sort. So every row's place in the new table is a merge rank: an old row's
// live prefix plus the fresh keys below it, a fresh voxel's fresh rank plus
// the live old keys below it, each a prefix count plus a binary search. The
// rows that are not live follow in index order, as the plain version's
// stable sort leaves them; a rank of C or more is the C-smallest-keys cut.
// Each output row is then written once: an old row with its appended
// points, normals, count lane and anchor, or a fresh row built from the
// sorted points, zero beyond its count.
//
// Numbers. The world transform is se3.transform_points and se3.quat_rotate
// operation by operation (__f*_rn, no contraction); the voxel index is the
// truncation of an IEEE quotient; the eviction distance adds its squares
// left to right and compares them with the float32 of radius^2, as PyTorch
// casts a scalar operand. Everything else moves bits.
//
// Bound on Hopper: device-memory bytes. A lane's table is read and written
// once by the assembly (2 C W 4 bytes, 128 MiB at C = 131,072, W = 128)
// and, where the output is the input table itself (the captured step), once
// more by its copy to a scratch buffer; the incoming points (28 bytes each)
// and the key arrays are small beside it.
//
// Design, per call (each launch covers every lane; the lane is blockIdx.y):
//   pass 1 (prologue), a thread per incoming point and per old row: the
//     point to the world, the owner mask, its key at the new origin and the
//     dropped count per block; the row's shifted key and eviction flag; the
//     table copied to the scratch buffer where the update is in place;
//   [torch.sort of the incoming keys, stable; K3's group lookup]
//   pass 2 (counts), a block per 1,024 rows or sorted points: each row's
//     liveness (an evicted row lives on if an incoming key equals its key, a
//     binary search) and each sorted point's "fresh leader" flag, as bit
//     words and block counts;
//   pass 3 (ranks), the same blocks: the block counts' prefixes in shared
//     memory, each row's and fresh leader's output rank, a descriptor per
//     output row (source row, group start, base count, new count), keys and
//     count written directly, the lane's size and dropped count;
//   pass 4 (assembly), a warp per output row: the row from its source (or
//     zero), the group's points, normals, anchor and count lane over it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // passes 1 and 4
constexpr int kChunk = 1024;    // passes 2 and 3: rows or sorted points a block
constexpr int kMaxChunks = 1024;
constexpr int kCopyUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyKey = 0x7FFFFFFF;
// key packing of ops/voxel_map.py (kernels/search.py): x [20..30], y [9..19], z [0..8]
constexpr int kYB = 11, kZB = 9;
constexpr int kXOff = 1 << 10, kYOff = 1 << 10, kZOff = 1 << 8;
constexpr int kXLim = (1 << 11) - 1, kYLim = (1 << 11) - 1, kZLim = (1 << 9) - 1;
// the keyframe map's column window (search.py _GHALF, _DIR_ZHALF, _DIR_ZLO)
constexpr int kGHalf = 512, kDirZHalf = 128, kDirZLo = kZOff - kDirZHalf;

struct Params {
  int C, N, K, W, RW, MB;
  int has_pose;    // the points are in the scan frame: transform them
  int rebase;      // a new origin from the center (else the old one, no eviction)
  int quantum;     // origin_quantum
  int owner_rank, owner_size;  // the spatial owner mask; size 0: none
  float vs, r2;    // voxel size, float32(radius^2)
};

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {  // se3.cross
  return {rsub(rmul(a.y, b.z), rmul(a.z, b.y)), rsub(rmul(a.z, b.x), rmul(a.x, b.z)),
          rsub(rmul(a.x, b.y), rmul(a.y, b.x))};
}

// se3.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ V3 quat_rotate(Q4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const V3 uv = cross(u, v);
  const V3 uuv = cross(u, uv);
  return {radd(v.x, rmul(2.0f, radd(rmul(q.w, uv.x), uuv.x))),
          radd(v.y, rmul(2.0f, radd(rmul(q.w, uv.y), uuv.y))),
          radd(v.z, rmul(2.0f, radd(rmul(q.w, uv.z), uuv.z)))};
}

// int32 arithmetic that wraps, as PyTorch's does
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// voxel_indices: truncation toward zero of an IEEE quotient
__device__ __forceinline__ int voxel_index(float x, float vs) {
  return (int)truncf(__fdiv_rn(x, vs));
}

__device__ __forceinline__ bool in_map_window(int rx, int ry, int rz) {
  return rz >= kDirZLo && rz < kDirZLo + 2 * kDirZHalf && rx >= kXOff - kGHalf &&
         rx < kXOff + kGHalf && ry >= kYOff - kGHalf && ry < kYOff + kGHalf;
}

// torch.div(a, q, rounding_mode="floor") for q > 0
__device__ __forceinline__ int floor_div(int a, int q) {
  const int d = a / q;
  return (a % q != 0 && a < 0) ? d - 1 : d;
}

// the lane's new origin: voxel_indices(center), x and y floored to multiples
// of the quantum; the old origin where the update does not rebase
__device__ __forceinline__ void lane_origin(const Params& p, const int* __restrict__ origin,
                                            const float* __restrict__ center, int b, int o[3]) {
  if (!p.rebase) {
    for (int l = 0; l < 3; ++l) o[l] = origin[3 * b + l];
    return;
  }
  for (int l = 0; l < 3; ++l) o[l] = voxel_index(center[3 * b + l], p.vs);
  if (p.quantum > 1)
    for (int l = 0; l < 2; ++l) o[l] = (int)((unsigned)floor_div(o[l], p.quantum) * (unsigned)p.quantum);
}

// the first index of the sorted a[0, n) whose value is >= key
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int n, int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// exclusive prefix of v over a block of kChunk threads; *total gets the sum
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s - w;
    if (lane == 31) *total = s;
  }
  __syncthreads();
  const int r = warp_sums[warp] + x - v;
  __syncthreads();
  return r;
}

// the number of set bits below position q of a lane's bit words, with the
// exclusive prefixes of its kChunk-bit block counts in `pre`
__device__ __forceinline__ int bits_below(const int* pre, const unsigned* __restrict__ words,
                                          int q) {
  const int c = q / kChunk;
  int r = pre[c];
  for (int w = c * (kChunk / 32); w < (q >> 5); ++w) r += __popc(words[w]);
  if (q & 31) r += __popc(words[q >> 5] & ((1u << (q & 31)) - 1u));
  return r;
}

// pass 1: blocks [0, nbp) a thread per incoming point, the rest a thread per
// old row (and the block's rows copied to the scratch table where given)
__global__ void __launch_bounds__(kThreads)
prologue_kernel(Params p, int nbp, const int* __restrict__ tab, const int* __restrict__ keys,
                const int* __restrict__ origin, const float* __restrict__ xyz,
                const float* __restrict__ nrm, const uint8_t* __restrict__ valid,
                const float* __restrict__ pose_t, const float* __restrict__ pose_q,
                const float* __restrict__ center, float* __restrict__ xyz_w,
                float* __restrict__ nrm_w, int* __restrict__ keys_in,
                int* __restrict__ dropped_part, int* __restrict__ keys1,
                uint8_t* __restrict__ row_flag, int* __restrict__ origin_out,
                int4* __restrict__ scratch) {
  const int b = blockIdx.y;
  int o[3];
  lane_origin(p, origin, center, b, o);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int l = 0; l < 3; ++l) origin_out[3 * b + l] = o[l];
  if ((int)blockIdx.x < nbp) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    bool dropped = false;
    if (i < p.N) {
      const long long pi = (long long)b * p.N + i;
      V3 v = {xyz[3 * pi], xyz[3 * pi + 1], xyz[3 * pi + 2]};
      bool ok = valid[pi] != 0;
      if (p.has_pose) {  // preprocess.transform_with_normals
        const Q4 q = {pose_q[4 * b], pose_q[4 * b + 1], pose_q[4 * b + 2], pose_q[4 * b + 3]};
        const V3 r = quat_rotate(q, v);
        v = {radd(r.x, pose_t[3 * b]), radd(r.y, pose_t[3 * b + 1]), radd(r.z, pose_t[3 * b + 2])};
        const V3 n = quat_rotate(q, {nrm[3 * pi], nrm[3 * pi + 1], nrm[3 * pi + 2]});
        xyz_w[3 * pi] = v.x;
        xyz_w[3 * pi + 1] = v.y;
        xyz_w[3 * pi + 2] = v.z;
        nrm_w[3 * pi] = n.x;
        nrm_w[3 * pi + 1] = n.y;
        nrm_w[3 * pi + 2] = n.z;
      }
      const int ix = voxel_index(v.x, p.vs), iy = voxel_index(v.y, p.vs),
                iz = voxel_index(v.z, p.vs);
      if (p.owner_size > 0) {  // spatial.owner_mask at the old origin
        int r = wadd(wsub(ix, origin[3 * b]), kGHalf) % p.owner_size;
        if (r < 0) r += p.owner_size;
        ok = ok && r == p.owner_rank;
      }
      // pack_keys(..., map_window=True) at the new origin
      const int rx = wadd(wsub(ix, o[0]), kXOff), ry = wadd(wsub(iy, o[1]), kYOff),
                rz = wadd(wsub(iz, o[2]), kZOff);
      const bool in = rx >= 0 && rx < kXLim && ry >= 0 && ry < kYLim && rz >= 0 && rz < kZLim &&
                      in_map_window(rx, ry, rz);
      const int key = ok && in ? (rx << (kYB + kZB)) | (ry << kZB) | rz : kEmptyKey;
      keys_in[pi] = key;
      dropped = ok && key == kEmptyKey;
    }
    const int n = __syncthreads_count(dropped);
    if (threadIdx.x == 0) dropped_part[b * nbp + blockIdx.x] = n;
    return;
  }
  const int r0 = (blockIdx.x - nbp) * kThreads;
  const int i = r0 + threadIdx.x;
  if (i < p.C) {
    const long long ri = (long long)b * p.C + i;
    const int key = keys[ri];
    const bool occupied = key != kEmptyKey;
    const int shift = wadd(wadd((int)((unsigned)wsub(o[0], origin[3 * b]) << (kYB + kZB)),
                                (int)((unsigned)wsub(o[1], origin[3 * b + 1]) << kZB)),
                           wsub(o[2], origin[3 * b + 2]));
    const int k1 = occupied ? wsub(key, shift) : kEmptyKey;
    bool evicted = false;
    if (occupied && p.rebase) {  // voxel_map._evict_mask
      const float* a = reinterpret_cast<const float*>(tab + ri * p.W + p.MB);
      const float dx = rsub(a[0], center[3 * b]), dy = rsub(a[1], center[3 * b + 1]),
                  dz = rsub(a[2], center[3 * b + 2]);
      const float d2 = radd(radd(rmul(dx, dx), rmul(dy, dy)), rmul(dz, dz));
      const unsigned u = (unsigned)k1;
      evicted = d2 > p.r2 || !in_map_window((int)(u >> (kYB + kZB)), (int)((u >> kZB) & 2047u),
                                             (int)(u & 511u));
    }
    keys1[ri] = k1;
    row_flag[ri] = (uint8_t)(occupied | (evicted << 1));
  }
  if (scratch != nullptr) {  // the old table, for an assembly in place
    const int w4 = p.W / 4;
    const long long n4 = (long long)min(kThreads, p.C - r0) * w4;
    const int4* src = reinterpret_cast<const int4*>(tab) + ((long long)b * p.C + r0) * w4;
    int4* dst = scratch + ((long long)b * p.C + r0) * w4;
    for (long long j = threadIdx.x; j < n4; j += kThreads * kCopyUnroll) {
      int4 v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u)
        if (j + u * kThreads < n4) v[u] = __ldcs(src + j + u * kThreads);
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u)
        if (j + u * kThreads < n4) dst[j + u * kThreads] = v[u];
    }
  }
}

// pass 2: blocks [0, ncr) a thread per old row (live), the rest a thread per
// sorted point (a fresh voxel's leader); bit words and block counts
__global__ void __launch_bounds__(kChunk)
count_kernel(Params p, int ncr, int nwr, int ncn, int nwn, const int* __restrict__ keys1,
             const uint8_t* __restrict__ row_flag, const int* __restrict__ skeys,
             const uint8_t* __restrict__ found, unsigned* __restrict__ live_words,
             int* __restrict__ live_count, unsigned* __restrict__ fresh_words,
             int* __restrict__ fresh_count) {
  const int b = blockIdx.y;
  const int* sk = skeys + (long long)b * p.N;
  bool flag = false;
  int c = blockIdx.x, n, nw;
  unsigned* words;
  int* counts;
  if (c < ncr) {
    const int i = c * kChunk + threadIdx.x;
    if (i < p.C) {
      const long long ri = (long long)b * p.C + i;
      const uint8_t f = row_flag[ri];
      if (f & 1) {
        flag = !(f & 2);
        if (!flag) {  // an evicted row lives on where an incoming key is its key
          const int k1 = keys1[ri];
          const int lb = lower_bound(sk, 0, p.N, k1);
          flag = lb < p.N && sk[lb] == k1;
        }
      }
    }
    n = ncr, nw = nwr, words = live_words, counts = live_count;
  } else {
    c -= ncr;
    const int s = c * kChunk + threadIdx.x;
    if (s < p.N) {
      const int key = sk[s];
      flag = key != kEmptyKey && (s == 0 || sk[s - 1] != key) && !found[(long long)b * p.N + s];
    }
    n = ncn, nw = nwn, words = fresh_words, counts = fresh_count;
  }
  const unsigned w = __ballot_sync(kFull, flag);
  const int wi = c * (kChunk / 32) + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && wi < nw) words[(long long)b * nw + wi] = w;
  const int total = __syncthreads_count(flag);
  if (threadIdx.x == 0) counts[b * n + c] = total;
}

// pass 3: the output rank of every old row and fresh leader, their
// descriptors, keys and counts; the lane's size and dropped count
__global__ void __launch_bounds__(kChunk)
rank_kernel(Params p, int ncr, int nwr, int ncn, int nwn, int nbp,
            const int* __restrict__ keys1, const int* __restrict__ count,
            const uint8_t* __restrict__ row_flag, const int* __restrict__ skeys,
            const int* __restrict__ pos_c, const unsigned* __restrict__ live_words,
            const int* __restrict__ live_count, const unsigned* __restrict__ fresh_words,
            const int* __restrict__ fresh_count, const int* __restrict__ dropped_part,
            int4* __restrict__ desc, int* __restrict__ keys_out, int* __restrict__ count_out,
            int* __restrict__ size_out, int* __restrict__ dropped_out) {
  __shared__ int pre_live[kMaxChunks + 1], pre_fresh[kMaxChunks + 1], warp_sums[32], total;
  const int b = blockIdx.y, t = threadIdx.x;
  const int e_live = block_scan(t < ncr ? live_count[b * ncr + t] : 0, warp_sums, &total);
  if (t < ncr) pre_live[t] = e_live;
  if (t == 0) pre_live[ncr] = total;
  __syncthreads();
  const int e_fresh = block_scan(t < ncn ? fresh_count[b * ncn + t] : 0, warp_sums, &total);
  if (t < ncn) pre_fresh[t] = e_fresh;
  if (t == 0) pre_fresh[ncn] = total;
  __syncthreads();
  const int L = pre_live[ncr], F = pre_fresh[ncn];
  const int* sk = skeys + (long long)b * p.N;
  const int* k1s = keys1 + (long long)b * p.C;
  const unsigned* lw = live_words + (long long)b * nwr;
  const long long out0 = (long long)b * p.C;
  int c = blockIdx.x;
  if (c < ncr) {
    const int i = c * kChunk + t;
    const bool live = i < p.C && ((lw[i >> 5] >> (i & 31)) & 1u);
    const int lp = pre_live[c] + block_scan(live, warp_sums, &total);
    if (i < p.C) {
      const long long ri = out0 + i;
      const uint8_t f = row_flag[ri];
      if (live) {
        const int k1 = k1s[i];
        const int lb = lower_bound(sk, 0, p.N, k1);
        const int out = lp + bits_below(pre_fresh, fresh_words + (long long)b * nwn, lb);
        if (out < p.C) {
          int4 d = make_int4(i, -1, 0, 0);
          int cnt = count[ri];
          if (lb < p.N && sk[lb] == k1) {  // touched: the group [lb, ub) appends
            const int ub = lower_bound(sk, lb, p.N, k1 + 1);
            const int base = (f & 2) ? 0 : cnt;
            cnt = min(base + (ub - lb), p.K);
            d = make_int4(i, lb, base, cnt);
          }
          desc[out0 + out] = d;
          keys_out[out0 + out] = k1;
          count_out[out0 + out] = cnt;
        }
      } else {  // after the merged rows, in index order
        const long long out = (long long)L + F + (i - lp);
        if (out < p.C) {
          desc[out0 + out] = make_int4(i, -1, 0, 0);
          keys_out[out0 + out] = kEmptyKey;
          count_out[out0 + out] = (f & 2) ? 0 : count[ri];
        }
      }
    }
  } else {
    c -= ncr;
    const int s = c * kChunk + t;
    const bool fresh =
        s < p.N && ((fresh_words[(long long)b * nwn + (s >> 5)] >> (s & 31)) & 1u);
    const int fp = pre_fresh[c] + block_scan(fresh, warp_sums, &total);
    if (fresh) {
      const int key = sk[s];
      const int pc = pos_c[(long long)b * p.N + s];
      const int q = pc + (k1s[pc] < key ? 1 : 0);  // K3 clamps the lower bound to C - 1
      const int out = fp + bits_below(pre_live, lw, q);
      if (out < p.C) {
        const int ub = lower_bound(sk, s, p.N, key + 1);
        const int cnt = min(ub - s, p.K);
        desc[out0 + out] = make_int4(-1, s, 0, cnt);
        keys_out[out0 + out] = key;
        count_out[out0 + out] = cnt;
      }
    }
  }
  if (blockIdx.x == 0 && t == 0) {
    size_out[b] = min(p.C, L + F);
    int d = 0;
    for (int j = 0; j < nbp; ++j) d += dropped_part[b * nbp + j];
    dropped_out[b] = d;
  }
}

// one 4-byte lane w of an output row whose group (sorted points from g)
// appends from `base` up to `cnt` points (voxel_map._lanes)
__device__ __forceinline__ int row_lane(const Params& p, int w, int v, int g, int base, int cnt,
                                        const long long* __restrict__ perm,
                                        const float* __restrict__ pts,
                                        const float* __restrict__ nrm) {
  const int K = p.K;
  if (w < 3 * K) {
    const int l = w / K, k = w - l * K;
    if (k >= base && k < cnt) v = __float_as_int(pts[3 * perm[g + k - base] + l]);
  } else if (w == 3 * K) {
    v = __float_as_int((float)cnt);
  } else if (w >= p.RW && w < p.RW + 3 * K) {
    const int k = (w - p.RW) / 3, l = w - p.RW - 3 * k;
    if (k >= base && k < cnt) v = __float_as_int(nrm[3 * perm[g + k - base] + l]);
  } else if (w >= p.MB && w < p.MB + 3 && base == 0) {
    v = __float_as_int(pts[3 * perm[g] + (w - p.MB)]);
  }
  return v;
}

// pass 4: a warp per output row
__global__ void __launch_bounds__(kThreads)
assemble_kernel(Params p, const int* __restrict__ old, const int4* __restrict__ desc,
                const long long* __restrict__ perm, const float* __restrict__ pts,
                const float* __restrict__ nrm, int* __restrict__ tab_out) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= p.C) return;
  const int4 d = desc[(long long)b * p.C + row];
  const int w4 = p.W / 4;
  const int4* src =
      d.x >= 0 ? reinterpret_cast<const int4*>(old) + ((long long)b * p.C + d.x) * w4 : nullptr;
  int4* dst = reinterpret_cast<int4*>(tab_out) + ((long long)b * p.C + row) * w4;
  const long long* pm = perm + (long long)b * p.N;
  const float* pb = pts + 3LL * b * p.N;
  const float* nb = nrm + 3LL * b * p.N;
  for (int c = lane; c < w4; c += 32) {
    int4 v = src != nullptr ? __ldcs(src + c) : make_int4(0, 0, 0, 0);
    if (d.y >= 0) {
      v.x = row_lane(p, 4 * c, v.x, d.y, d.z, d.w, pm, pb, nb);
      v.y = row_lane(p, 4 * c + 1, v.y, d.y, d.z, d.w, pm, pb, nb);
      v.z = row_lane(p, 4 * c + 2, v.z, d.y, d.z, d.w, pm, pb, nb);
      v.w = row_lane(p, 4 * c + 3, v.w, d.y, d.z, d.w, pm, pb, nb);
    }
    dst[c] = v;
  }
}

Params make_params(int C, int N, int K, int W, int RW, int MB, int has_pose, int rebase,
                   int quantum, int owner_rank, int owner_size, float vs, float r2) {
  return {C, N, K, W, RW, MB, has_pose, rebase, quantum, owner_rank, owner_size, vs, r2};
}

int chunks(int n) { return (n + kChunk - 1) / kChunk; }

}  // namespace

// pass 1; scratch null where the assembly does not write the input table
extern "C" int map_update_prologue_launch(
    const int* tab, const int* keys, const int* origin, const float* xyz, const float* nrm,
    const uint8_t* valid, const float* pose_t, const float* pose_q, const float* center, int B,
    int C, int N, int K, int W, int RW, int MB, int has_pose, int rebase, int quantum,
    int owner_rank, int owner_size, float vs, float r2, float* xyz_w, float* nrm_w,
    int* keys_in, int* dropped_part, int* keys1, uint8_t* row_flag, int* origin_out,
    int* scratch, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Params p = make_params(C, N, K, W, RW, MB, has_pose, rebase, quantum, owner_rank,
                               owner_size, vs, r2);
  const int nbp = (N + kThreads - 1) / kThreads, nbr = (C + kThreads - 1) / kThreads;
  prologue_kernel<<<dim3(nbp + nbr, B), kThreads, 0, stream>>>(
      p, nbp, tab, keys, origin, xyz, nrm, valid, pose_t, pose_q, center, xyz_w, nrm_w, keys_in,
      dropped_part, keys1, row_flag, origin_out, reinterpret_cast<int4*>(scratch));
  return (int)cudaGetLastError();
}

// passes 2-4, after the incoming keys' sort (skeys, perm) and K3's group
// lookup of them in keys1 (pos_c, found)
extern "C" int map_update_finish_launch(
    const int* old, const int* count, const float* pts, const float* nrm, int B, int C, int N,
    int K, int W, int RW, int MB, const int* keys1, const uint8_t* row_flag, const int* skeys,
    const long long* perm, const int* pos_c, const uint8_t* found, const int* dropped_part,
    unsigned* live_words, int* live_count, unsigned* fresh_words, int* fresh_count, int* desc,
    int* tab_out, int* keys_out, int* count_out, int* size_out, int* dropped_out,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  const Params p = make_params(C, N, K, W, RW, MB, 0, 0, 1, 0, 0, 0.0f, 0.0f);
  const int ncr = chunks(C), ncn = chunks(N), nwr = (C + 31) / 32, nwn = (N + 31) / 32;
  const int nbp = (N + kThreads - 1) / kThreads;
  if (ncr > kMaxChunks || ncn > kMaxChunks) return (int)cudaErrorInvalidValue;
  count_kernel<<<dim3(ncr + ncn, B), kChunk, 0, stream>>>(p, ncr, nwr, ncn, nwn, keys1, row_flag,
                                                          skeys, found, live_words, live_count,
                                                          fresh_words, fresh_count);
  int4* d = reinterpret_cast<int4*>(desc);
  rank_kernel<<<dim3(ncr + ncn, B), kChunk, 0, stream>>>(
      p, ncr, nwr, ncn, nwn, nbp, keys1, count, row_flag, skeys, pos_c, live_words, live_count,
      fresh_words, fresh_count, dropped_part, d, keys_out, count_out, size_out, dropped_out);
  assemble_kernel<<<dim3((C + kThreads / 32 - 1) / (kThreads / 32), B), kThreads, 0, stream>>>(
      p, old, d, perm, pts, nrm, tab_out);
  return (int)cudaGetLastError();
}
