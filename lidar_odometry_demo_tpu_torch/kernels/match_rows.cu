// Kernel K1: per-query first-minimum re-match of cached ICP candidates.
//
// Replaces the TPU kernel lidar_odometry_demo_tpu/ops/pallas/correspondence.py
// (_match_kernel / match_rows). For each query it gates 27 voxel slices
// (9 columns x z-1/z/z+1) of K candidates by slice presence (s < n_present),
// slot count (k < cnt) and the strict distance gate d2 < max_d2, and returns
// the FIRST minimum in (column, z, k) order: the winning point, its flat index
// c*3K + z*K + k, and its d2. A query without a valid candidate gets d2 exactly
// max_d2 and index 0.
//
// Bound on Hopper: device-memory bytes. Each ICP round streams the candidate
// lanes of every present slice (up to 3 x 9 x Q x (3K+1) x 4 B, ~54 MB at
// Q = 8192, K = 20) and does ~10 flops per candidate. Design: one warp per
// query; lanes cover the K candidates of a slice (coalesced 4-byte reads of
// each planar coordinate block), slices absent by n_present are never read,
// and a (d2, k) lexicographic warp-shuffle min keeps the first minimum; a
// strict < between slices keeps the earliest slice. d2 is computed with
// non-contracted multiplies and adds, so it is bitwise the plain PyTorch
// version's and the winner index is identical.
//
// Layout: rows_z[s] is (9*Q, RW) float32 bits, column-major (9, Q) row order;
// lanes [0,K) x, [K,2K) y, [2K,3K) z, [3K] count as f32. n_present is (9, Q).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void warp_first_min(float& d, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(0xffffffffu, d, off);
    int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (od < d || (od == d && ok < k)) {
      d = od;
      k = ok;
    }
  }
}

__global__ void match_rows_kernel(const float* __restrict__ q_world,
                                  const float* __restrict__ rows0,
                                  const float* __restrict__ rows1,
                                  const float* __restrict__ rows2,
                                  const int* __restrict__ n_present, int Q,
                                  int K, int RW, float max_d2,
                                  float* __restrict__ out_point,
                                  int* __restrict__ out_index,
                                  float* __restrict__ out_d2) {
  const int q = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // uniform across the warp
  const float qx = q_world[3 * q + 0];
  const float qy = q_world[3 * q + 1];
  const float qz = q_world[3 * q + 2];

  float best_d = max_d2;
  int best_i = 0;
  for (int c = 0; c < 9; ++c) {
    const int np = n_present[c * Q + q];
    const long long row = ((long long)c * Q + q) * RW;
    for (int s = 0; s < np && s < 3; ++s) {
      const float* r = (s == 0 ? rows0 : s == 1 ? rows1 : rows2) + row;
      const float cnt = r[3 * K];
      float d = max_d2;
      int kk = K;  // sentinel above every real k
      for (int k = lane; k < K; k += 32) {
        const float dx = __fsub_rn(r[k], qx);
        const float dy = __fsub_rn(r[K + k], qy);
        const float dz = __fsub_rn(r[2 * K + k], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const float g = ((float)k < cnt && d2 < max_d2) ? d2 : max_d2;
        if (g < d) {  // k grows within a lane: strict < keeps the first
          d = g;
          kk = k;
        }
      }
      warp_first_min(d, kk);
      if (d < best_d) {  // strict: the earlier slice wins ties
        best_d = d;
        best_i = (c * 3 + s) * K + kk;
      }
    }
  }
  if (lane == 0) {
    const int c = best_i / (3 * K);
    const int zk = best_i - c * 3 * K;
    const int s = zk / K;
    const int k = zk - s * K;
    const float* r =
        (s == 0 ? rows0 : s == 1 ? rows1 : rows2) + ((long long)c * Q + q) * RW;
    out_point[3 * q + 0] = r[k];
    out_point[3 * q + 1] = r[K + k];
    out_point[3 * q + 2] = r[2 * K + k];
    out_index[q] = best_i;
    out_d2[q] = best_d;
  }
}

}  // namespace

extern "C" int match_rows_launch(const void* q_world, const void* rows0,
                                 const void* rows1, const void* rows2,
                                 const void* n_present, int Q, int K, int RW,
                                 float max_d2, void* out_point, void* out_index,
                                 void* out_d2, void* stream) {
  if (Q == 0) return 0;
  const int threads = 256;  // 8 queries per block
  const long long blocks = ((long long)Q * 32 + threads - 1) / threads;
  match_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)q_world, (const float*)rows0, (const float*)rows1,
      (const float*)rows2, (const int*)n_present, Q, K, RW, max_d2,
      (float*)out_point, (int*)out_index, (float*)out_d2);
  return (int)cudaGetLastError();
}
