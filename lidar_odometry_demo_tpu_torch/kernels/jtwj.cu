// Kernel K2: robust point-to-plane normal equations H = J^T W J, b = J^T W r.
//
// Replaces the TPU kernel lidar_odometry_demo_tpu/ops/pallas/jtwj.py
// (_jtwj_kernel / jtwj_accumulate). Per correspondence i:
//   p_w = R p_i + t;  r = n_i . (p_w - o_i);  w = min(1, delta/|r|) * valid_i;
//   J = [ (R p_i) x n_i , n_i ];  H += J^T w J;  b += J^T w r.
// The translation prior is left to the caller.
//
// Bound on Hopper: neither bytes nor flops. One call reads ~37 B and does
// ~150 flops per correspondence (~0.3 MB and ~1.2 MFLOP at Q = 8192), well
// under a microsecond of either; the launch itself bounds it. Design: pass 1
// gives each thread a grid-stride share of the rows, keeps the 27 unique sums
// (21 of the upper triangle of H, 6 of b) in registers, reduces them over the
// warp with shuffles and over the block's warps in a fixed order, and writes
// one 27-float partial per block. Pass 2, one block, sums the partials in
// block order and writes H (both triangles) and b. No atomics: the grid and
// every summation order depend on Q alone, so two runs on the same input are
// bitwise equal. float32 FMA only; no tensor cores (no TF32).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;
constexpr int kMaxBlocks = 264;  // two per SM on an H100

__global__ void jtwj_partial_kernel(const float* __restrict__ source_local,
                                    const float* __restrict__ plane_origin,
                                    const float* __restrict__ plane_normal,
                                    const unsigned char* __restrict__ valid,
                                    const float* __restrict__ R,
                                    const float* __restrict__ t, int Q,
                                    float huber_delta,
                                    float* __restrict__ partials) {
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  const float r00 = R[0], r01 = R[1], r02 = R[2];
  const float r10 = R[3], r11 = R[4], r12 = R[5];
  const float r20 = R[6], r21 = R[7], r22 = R[8];
  const float t0 = t[0], t1 = t[1], t2 = t[2];

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < Q;
       i += gridDim.x * kThreads) {
    const float px = source_local[3 * i], py = source_local[3 * i + 1],
                pz = source_local[3 * i + 2];
    const float nx = plane_normal[3 * i], ny = plane_normal[3 * i + 1],
                nz = plane_normal[3 * i + 2];
    // R p as the plain version's element-wise multiply-adds
    const float rp0 = __fadd_rn(__fadd_rn(__fmul_rn(px, r00), __fmul_rn(py, r01)), __fmul_rn(pz, r02));
    const float rp1 = __fadd_rn(__fadd_rn(__fmul_rn(px, r10), __fmul_rn(py, r11)), __fmul_rn(pz, r12));
    const float rp2 = __fadd_rn(__fadd_rn(__fmul_rn(px, r20), __fmul_rn(py, r21)), __fmul_rn(pz, r22));
    const float e0 = __fsub_rn(__fadd_rn(rp0, t0), plane_origin[3 * i]);
    const float e1 = __fsub_rn(__fadd_rn(rp1, t1), plane_origin[3 * i + 1]);
    const float e2 = __fsub_rn(__fadd_rn(rp2, t2), plane_origin[3 * i + 2]);
    const float r = e0 * nx + e1 * ny + e2 * nz;
    const float absr = fabsf(r);
    float w = absr <= huber_delta ? 1.f : huber_delta / fmaxf(absr, 1e-30f);
    w = valid[i] ? w : 0.f;
    const float J[6] = {rp1 * nz - rp2 * ny, rp2 * nx - rp0 * nz,
                        rp0 * ny - rp1 * nx, nx, ny, nz};
    int j = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wa = J[a] * w;
#pragma unroll
      for (int c = a; c < 6; ++c) acc[j++] += wa * J[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += J[a] * w * r;
  }

  __shared__ float warp_sums[kWarps][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
    for (int w8 = 0; w8 < kWarps; ++w8) s += warp_sums[w8][threadIdx.x];
    partials[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

__global__ void jtwj_final_kernel(const float* __restrict__ partials,
                                  int n_blocks, float* __restrict__ H,
                                  float* __restrict__ b) {
  const int j = threadIdx.x;
  if (j >= kSums) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) s += partials[blk * kSums + j];
  if (j >= 21) {
    b[j - 21] = s;
    return;
  }
  int a = 0, rem = j;  // j -> (a, c) of the row-major upper triangle
  while (rem >= 6 - a) {
    rem -= 6 - a;
    ++a;
  }
  const int c = a + rem;
  H[a * 6 + c] = s;
  H[c * 6 + a] = s;
}

}  // namespace

extern "C" int jtwj_blocks(int Q) {
  const int need = (Q + kThreads - 1) / kThreads;
  return need < 1 ? 1 : (need > kMaxBlocks ? kMaxBlocks : need);
}

// partials: scratch of jtwj_blocks(Q) * 27 floats; H (6, 6); b (6,).
extern "C" int jtwj_launch(const void* source_local, const void* plane_origin,
                           const void* plane_normal, const void* valid,
                           const void* R, const void* t, int Q,
                           float huber_delta, void* partials, void* H, void* b,
                           void* stream) {
  const int n_blocks = jtwj_blocks(Q);
  cudaStream_t s = (cudaStream_t)stream;
  jtwj_partial_kernel<<<n_blocks, kThreads, 0, s>>>(
      (const float*)source_local, (const float*)plane_origin,
      (const float*)plane_normal, (const unsigned char*)valid, (const float*)R,
      (const float*)t, Q, huber_delta, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  jtwj_final_kernel<<<1, 32, 0, s>>>((const float*)partials, n_blocks,
                                     (float*)H, (float*)b);
  return (int)cudaGetLastError();
}
