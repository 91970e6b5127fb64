// Kernel K1: per-query first-minimum re-match of cached ICP candidates, with
// the correspondence written in full.
//
// Replaces the TPU kernel lidar_odometry_demo_tpu/ops/pallas/correspondence.py
// (_match_kernel / match_rows) and the work around it in
// voxel_map.match_candidates. For each query it computes
// q_world = R q_local + t (se3.rot_pts's order), gates the 27 voxel slices
// (9 columns x z-1/z/z+1) of K candidates by slice presence
// (s < n_present), slot count (k < cnt) and the strict distance gate
// d2 < max_d2, and keeps the FIRST minimum in (column, z, k) order. That is
// the lexicographic minimum of (d2, flat index) over all candidates, with
// flat index c*3K + s*K + k = slice*K + k and the running best starting at
// (max_d2, 0): a gated candidate never beats it. It writes the winning point
// and the winner's normal (from the table row at slot
// clamp(base[c] + s, C-1), lanes RW + 3k .. RW + 3k + 2), zeroed where the
// query is invalid, valid = query_valid & (d2 < max_d2), the flat index and
// d2. A query without a valid candidate gets d2 exactly max_d2 and index 0.
//
// Bound on Hopper: device-memory bytes (the present slices' counts and
// candidates, ~14 MB a round at Q = 8192, K = 20) and the latency of
// dependent loads. Design: one warp per query; every wave of loads covers
// all 27 slices at once, where the old kernel walked them one by one
// (load, dependent load, reduce). (1) Lane s < 27 loads slice s's n_present
// and column base, then the count lane of each present slice. (2) A warp
// prefix sum numbers the live candidates (k < count) slice by slice. The
// lanes take the live slots 32 at a time, batches of kUnroll with all their
// loads issued before any is used, straight from the rows: that reads only
// the sectors the counts need, and without shared memory 64 warps fit an SM
// (a TMA copy of each live row into shared memory was slower on the H100,
// PERF.md). (3) Each lane keeps its (d2, slot) minimum, one warp-level
// lexicographic shuffle min picks the winner, and lanes 0..2 read its point
// and normal. d2 is computed with non-contracted
// multiplies and adds, so it is bitwise the plain PyTorch version's and the
// winner index is identical.
//
// Layout: rows_z[s] is (9*Q, RW) float32 bits, column-major (9, Q) row order;
// lanes [0,K) x, [K,2K) y, [2K,3K) z, [3K] count as f32. n_present and base
// are (9, Q); tab is (C, W).
//
// Lanes: B independent sequences in one launch. Every input and output
// above gains a leading B (query (B, Q, 3), R (B, 3, 3), t (B, 3), rows_z[s]
// (B, 9*Q, RW), tab (B, C, W), ...), and the lane is the grid's second
// dimension. A lane's work is the B = 1 kernel's on that lane's inputs, so
// its result is bitwise the same. The lane enters as index offsets (the
// query's index over all lanes, its first candidate row), not as moved
// pointers, which would hold registers the 32-register budget lacks.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // queries per block
constexpr int kSlices = 27;
constexpr unsigned kFull = 0xffffffffu;

// 32-slot batches whose loads are issued together: 2 keeps the kernel at
// 32 registers, 16 blocks (64 warps) per SM; 3 or 4 spill or lose warps
constexpr int kUnroll = 2;

__global__ void __launch_bounds__(kWarps * 32, 16)
match_kernel(const float* __restrict__ query, const unsigned char* __restrict__ query_valid,
             const float* __restrict__ R, const float* __restrict__ t,
             const float* __restrict__ rows0, const float* __restrict__ rows1,
             const float* __restrict__ rows2, const int* __restrict__ n_present,
             const int* __restrict__ base, const float* __restrict__ tab, int Q, int K,
             int RW, int C, int W, float max_d2, float* __restrict__ out_origin,
             float* __restrict__ out_normal, unsigned char* __restrict__ out_valid,
             int* __restrict__ out_index, float* __restrict__ out_d2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // uniform across the warp; no block-wide barrier below
  const int b = blockIdx.y;  // the sequence
  const int gq = b * Q + q;  // the query over all lanes (the launcher keeps 9 B Q < 2^31)
  const int col0 = (9 * b) * Q + q;  // its column 0's candidate row

  // (1) slice j = lane: column c = j / 3, z-slot s = j % 3; its presence
  // and column base, and the query, all loaded at once; then the count lanes
  // of the present slices, all at once (an absent slice's would cost a
  // sector each for nothing)
  const int j = lane;
  const int c = j / 3, s = j - 3 * (j / 3);
  int np = 0, bs = 0;
  float cnt = -1.f;
  const float* row = rows0;
  if (j < kSlices) {
    const long long cq = col0 + c * Q;
    row = (s == 0 ? rows0 : s == 1 ? rows1 : rows2) + cq * RW;
    np = n_present[cq];
    if (base != nullptr) bs = base[cq];
  }
  float qx = query[3 * gq], qy = query[3 * gq + 1], qz = query[3 * gq + 2];
  const bool qvalid = query_valid == nullptr || query_valid[gq] != 0;
  if (R != nullptr) {  // rot_pts(q, R) + t, element-wise in its order
    R += 9 * b;
    t += 3 * b;
    const float x = qx, y = qy, z = qz;
    qx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[0]), __fmul_rn(y, R[1])), __fmul_rn(z, R[2])), t[0]);
    qy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[3]), __fmul_rn(y, R[4])), __fmul_rn(z, R[5])), t[1]);
    qz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[6]), __fmul_rn(y, R[7])), __fmul_rn(z, R[8])), t[2]);
  }
  if (j < kSlices && s < np) cnt = row[3 * K];
  // the slice's live candidates: k < n_k <=> (float)k < cnt, for a present
  // slice; their slots are numbered slice by slice from `first`
  const bool live = cnt > 0.f;
  const int n_k = live ? (int)ceilf(fminf(cnt, (float)K)) : 0;
  int incl = n_k;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int first = incl - n_k;

  auto lanes_of = [&](int js) -> const float* {  // slice js's x lanes
    const int cs = js / 3, ss = js - 3 * (js / 3);
    return (ss == 0 ? rows0 : ss == 1 ? rows1 : rows2) + (long long)(col0 + cs * Q) * RW;
  };

  // (2) live slot u = lane + 32 i, in batches whose loads go out together:
  // its slice is the last one numbered from at most u (a binary search over
  // the lanes' `first`), its candidate u - first. Slots grow within a lane
  // and so do their flat indices slice*K + k, so a strict < keeps the
  // lane's first minimum; d2 < bd also applies the distance gate.
  float bd = max_d2;
  int bi = 0;
  for (int u0 = 0; u0 < total; u0 += 32 * kUnroll) {
    float x[kUnroll], y[kUnroll], z[kUnroll];
    int fi[kUnroll];
#pragma unroll
    for (int b = 0; b < kUnroll; ++b) {
      const int u = u0 + 32 * b + lane;
      int js = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, first, js + step) <= u) js += step;
      }
      const int k = u - __shfl_sync(kFull, first, js);
      fi[b] = u < total ? js * K + k : -1;
      if (u < total) {
        const float* l = lanes_of(js);
        x[b] = l[k];
        y[b] = l[K + k];
        z[b] = l[2 * K + k];
      }
    }
#pragma unroll
    for (int b = 0; b < kUnroll; ++b) {
      if (fi[b] < 0) continue;
      const float dx = __fsub_rn(x[b], qx);
      const float dy = __fsub_rn(y[b], qy);
      const float dz = __fsub_rn(z[b], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < bd) {
        bd = d2;
        bi = fi[b];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, bd, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (od < bd || (od == bd && oi < bi)) {
      bd = od;
      bi = oi;
    }
  }

  // (3) the winner's point and normal (from the table)
  const int wj = bi / K, wk = bi - (bi / K) * K;
  const int bw = __shfl_sync(kFull, bs, wj);
  const bool valid = qvalid && bd < max_d2;
  if (lane < 3) {
    out_origin[3 * gq + lane] = valid ? lanes_of(wj)[lane * K + wk] : 0.f;
    if (out_normal != nullptr) {
      float n = 0.f;
      if (valid) {
        const int slot = min(bw + (wj - 3 * (wj / 3)), C - 1);
        n = tab[((long long)b * C + slot) * W + RW + 3 * wk + lane];
      }
      out_normal[3 * gq + lane] = n;
    }
  }
  if (lane == 0) {
    if (out_valid != nullptr) out_valid[gq] = valid;
    out_index[gq] = bi;
    out_d2[gq] = bd;
  }
}

}  // namespace

// One launch for B lanes. Pose mode: R (B, 3, 3), t (B, 3) given, `query`
// is the local point and q_world = R q + t; query_valid, base, tab and
// out_normal given. Point mode (match_rows): R, t, query_valid, base, tab,
// out_normal and out_valid nullptr, `query` is q_world.
extern "C" int match_launch(const void* query, const void* query_valid, const void* R,
                            const void* t, const void* rows0, const void* rows1,
                            const void* rows2, const void* n_present, const void* base,
                            const void* tab, int B, int Q, int K, int RW, int C, int W,
                            float max_d2, void* out_origin, void* out_normal,
                            void* out_valid, void* out_index, void* out_d2, void* stream) {
  if ((long long)B * 9 * Q >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (Q == 0 || B == 0) return 0;
  const dim3 blocks((Q + kWarps - 1) / kWarps, B);
  match_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const unsigned char*)query_valid, (const float*)R,
      (const float*)t, (const float*)rows0, (const float*)rows1, (const float*)rows2,
      (const int*)n_present, (const int*)base, (const float*)tab, Q, K, RW, C, W, max_d2,
      (float*)out_origin, (float*)out_normal, (unsigned char*)out_valid, (int*)out_index,
      (float*)out_d2);
  return (int)cudaGetLastError();
}
