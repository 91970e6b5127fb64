// Kernel K2: one whole Gauss-Newton step of the point-to-plane ICP in one
// launch, or (epilogue off) the robust normal equations H = J^T W J,
// b = J^T W r alone, at the same pose.
//
// Replaces the TPU kernel lidar_odometry_demo_tpu/ops/pallas/jtwj.py
// (_jtwj_kernel / jtwj_accumulate) and, in step mode, the scalar work the
// JAX package runs after it (icp._gn_steps: the translation prior, the
// damping, solve_spd_6x6 and se3.apply_delta). Per correspondence i:
//   p_w = R p_i + t;  r = n_i . (p_w - o_i);  w = min(1, delta/|r|) * valid_i;
//   J = [ (R p_i) x n_i , n_i ];  H += J^T w J;  b += J^T w r.
//
// Bound on Hopper: neither bytes nor flops. One step reads ~37 B and does
// ~100 flops per correspondence (~0.3 MB and ~0.8 MFLOP at Q = 8192), a
// tenth of a microsecond of either; what costs is the launch, the reduction
// across blocks and the serial 6x6 epilogue. What followed the kernel before
// (the unrolled solve and pose update, ~200 scalar launches a step) is gone.
//
// Design: one thread-block cluster of kBlocks = 16 blocks of 256 threads,
// the largest cluster Hopper allows (non-portable: the launch opts in). At
// Q = 8192 each of the 4096 threads takes two rows, loaded together with
// the pose in one round trip; the row arithmetic is issue-bound, so 16 SMs
// take half the time of the portable 8, while more SMs than one cluster
// holds would need a second reduction across clusters. The 0.3 MB read is
// ~19 KB per SM. Each
// thread keeps the 27 unique sums (21 of the upper triangle of H, 6 of b) in
// registers; a block reduces them over the warp by a butterfly of 31
// shuffles and over its warps in a fixed order, and stores them into block
// rank 0's shared memory through distributed shared memory; a split cluster
// barrier (arrive at entry, wait before the stores; release-arrive after
// them, and only rank 0 waits) orders it, and rank 0 sums the blocks in rank
// order. The grid and every summation
// order depend on Q alone and no atomic adds floats, so two runs on the same
// input are bitwise equal. float32 only; no tensor cores.
//
// In both modes R comes from the pose's quaternion, read from device memory
// (se3.quat_to_matrix's formula). In step mode thread 0 of rank 0 then
// runs, as icp._normal_equations and _gn_steps do on tensors: the translation prior,
// H + damping diag(H) + 1e-9 I, the unrolled Cholesky solve with the
// clamp_min(., 1e-12) pivot guard, delta = -x, apply_delta (quat_exp with
// its small-angle branch, quat_mul, quat_normalize) and |delta|. Every
// multiply, add and divide there is a non-contracted IEEE operation in the
// plain version's order (sinf / cosf / sqrtf, not the fast intrinsics).
// H and b are written as the sums, before the prior and the damping.
//
// Lanes: B independent systems in one launch, one 16-block cluster each
// (grid 16 B, cluster dims (16, 1, 1)); cluster c serves lane c. Every input
// and output gains a leading B, and each lane's sums keep their rank order,
// so a lane's result is bitwise the B = 1 launch's on its inputs. In step
// mode a (B,) `active` flag may be given: the blocks of an inactive lane
// copy its input pose and step norm to its output slot and return before
// any barrier (H and b are not written), so the ICP loop needs no tensor op
// between its steps to hold a finished lane still.
//
// Split step (a group of ranks, each holding part of the correspondences):
// the sum over the ranks must come between the accumulation and the solve.
// The step then is this kernel with the epilogue off (H and b at the pose,
// R derived as in step mode, so a group of one gives the fused step's bits),
// the caller's all-reduce of H and b, and the second entry point,
// gn_epilogue_kernel: one thread per lane runs the same step_epilogue on the
// summed H and b.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlocks = 16;  // one cluster (a non-portable size on Hopper)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float lo) { return a < lo ? lo : a; }

// se3.quat_to_matrix, element by element in its order
__device__ void quat_to_matrix(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  R[0] = sub(1.f, mul(2.f, add(yy, zz)));
  R[1] = mul(2.f, sub(xy, wz));
  R[2] = mul(2.f, add(xz, wy));
  R[3] = mul(2.f, add(xy, wz));
  R[4] = sub(1.f, mul(2.f, add(xx, zz)));
  R[5] = mul(2.f, sub(yz, wx));
  R[6] = mul(2.f, sub(xz, wy));
  R[7] = mul(2.f, add(yz, wx));
  R[8] = sub(1.f, mul(2.f, add(xx, yy)));
}

// One halving of the butterfly reduce-scatter: a lane keeps the half of
// its kHalf*2 values that its lane bit kHalf selects and adds its partner's
// copy of that half.
template <int kHalf>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float give = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, give, kHalf);
  }
}

// One correspondence's inputs, loaded before any is used.
struct Row {
  float px, py, pz, ox, oy, oz, nx, ny, nz;
  bool valid;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ source_local,
                                        const float* __restrict__ plane_origin,
                                        const float* __restrict__ plane_normal,
                                        const unsigned char* __restrict__ valid, int i) {
  return Row{source_local[3 * i], source_local[3 * i + 1], source_local[3 * i + 2],
             plane_origin[3 * i], plane_origin[3 * i + 1], plane_origin[3 * i + 2],
             plane_normal[3 * i], plane_normal[3 * i + 1], plane_normal[3 * i + 2],
             valid[i] != 0};
}

// Row i's terms added to the 27 sums: p_w, r, the Huber weight and J as
// the plain version's element-wise products and sums.
__device__ __forceinline__ void accumulate(const Row& x, const float* R, float t0,
                                           float t1, float t2, float huber_delta,
                                           float* acc) {
  const float rp0 = add(add(mul(x.px, R[0]), mul(x.py, R[1])), mul(x.pz, R[2]));
  const float rp1 = add(add(mul(x.px, R[3]), mul(x.py, R[4])), mul(x.pz, R[5]));
  const float rp2 = add(add(mul(x.px, R[6]), mul(x.py, R[7])), mul(x.pz, R[8]));
  const float e0 = sub(add(rp0, t0), x.ox);
  const float e1 = sub(add(rp1, t1), x.oy);
  const float e2 = sub(add(rp2, t2), x.oz);
  const float r = add(add(mul(e0, x.nx), mul(e1, x.ny)), mul(e2, x.nz));
  const float absr = fabsf(r);
  float w = absr <= huber_delta ? 1.f : dvd(huber_delta, fmaxf(absr, 1e-30f));
  w = x.valid ? w : 0.f;
  const float J[6] = {sub(mul(rp1, x.nz), mul(rp2, x.ny)), sub(mul(rp2, x.nx), mul(rp0, x.nz)),
                      sub(mul(rp0, x.ny), mul(rp1, x.nx)), x.nx, x.ny, x.nz};
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

// The prior, the damping, the solve and the pose update (one thread).
// sums: the 27 sums; writes (t, q, |delta|) to pose_out[0..7].
__device__ void step_epilogue(const float* sums, const float* t, const float* q,
                              const float* guess_t, float prior_w, float damping,
                              float* pose_out) {
  float H[6][6], b[6];
  int j = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) {
      H[a][c] = sums[j];
      H[c][a] = sums[j++];
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) b[a] = sums[21 + a];
  // translation prior (icp._normal_equations), then the damping (_gn_steps)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    H[3 + i][3 + i] = add(H[3 + i][3 + i], prior_w);
    b[3 + i] = add(b[3 + i], mul(prior_w, sub(t[i], guess_t[i])));
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i][i] = add(add(H[i][i], mul(damping, H[i][i])), 1e-9f);

  // solve_spd_6x6: unrolled Cholesky, forward and back substitution
  float L[6][6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float s = H[c][c];
#pragma unroll
    for (int k = 0; k < c; ++k) s = sub(s, mul(L[c][k], L[c][k]));
    const float diag = sqrtf(clamp_min(s, 1e-12f));
    L[c][c] = diag;
    const float inv_d = dvd(1.f, diag);
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      float v = H[i][c];
#pragma unroll
      for (int k = 0; k < c; ++k) v = sub(v, mul(L[i][k], L[c][k]));
      L[i][c] = mul(v, inv_d);
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], y[k]));
    y[i] = dvd(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = sub(s, mul(L[k][i], x[k]));
    x[i] = dvd(s, L[i][i]);
  }
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = -x[i];

  // apply_delta: q_new = normalize(quat_exp(d[0:3]) * q), t_new = t + d[3:6]
  const float theta_sq = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
  const float theta = sqrtf(theta_sq);
  const float half = mul(0.5f, theta);
  const bool small = theta_sq < 1e-12f;
  const float k = small ? sub(0.5f, dvd(theta_sq, 48.f)) : dvd(sinf(half), theta);
  const float aw = small ? sub(1.f, dvd(theta_sq, 8.f)) : cosf(half);
  const float ax = mul(k, d[0]), ay = mul(k, d[1]), az = mul(k, d[2]);
  const float bw = q[0], bx = q[1], by = q[2], bz = q[3];
  float qn[4];
  qn[0] = sub(sub(sub(mul(aw, bw), mul(ax, bx)), mul(ay, by)), mul(az, bz));
  qn[1] = sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by));
  qn[2] = add(add(sub(mul(aw, by), mul(ax, bz)), mul(ay, bw)), mul(az, bx));
  qn[3] = add(sub(add(mul(aw, bz), mul(ax, by)), mul(ay, bx)), mul(az, bw));
  const float qq = add(add(add(mul(qn[0], qn[0]), mul(qn[1], qn[1])), mul(qn[2], qn[2])),
                       mul(qn[3], qn[3]));
  const float qnorm = clamp_min(sqrtf(qq), 1e-12f);
  float dd = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) dd = add(dd, mul(d[i], d[i]));
#pragma unroll
  for (int i = 0; i < 3; ++i) pose_out[i] = add(t[i], d[3 + i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) pose_out[3 + i] = dvd(qn[i], qnorm);
  pose_out[7] = sqrtf(dd);
}

// An inactive lane's output: its input pose and step norm, unchanged (read
// whole before the first write, so pose_out may alias the input pose).
__device__ void keep_pose(const float* t, const float* q, float norm, float* pose_out) {
  float keep[8];
#pragma unroll
  for (int i = 0; i < 3; ++i) keep[i] = t[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) keep[3 + i] = q[i];
  keep[7] = norm;
#pragma unroll
  for (int i = 0; i < 8; ++i) pose_out[i] = keep[i];
}

__global__ void __launch_bounds__(kThreads, 1)
gn_step_kernel(const float* __restrict__ source_local,
               const float* __restrict__ plane_origin,
               const float* __restrict__ plane_normal,
               const unsigned char* __restrict__ valid, const float* t_in, int t_stride, const float* q_in, int q_stride,
               const float* norm_in, int norm_stride, const unsigned char* active,
               const float* guess_t, int Q, float huber_delta, float prior_w,
               float damping, float* __restrict__ H_out, float* __restrict__ b_out,
               float* pose_out) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float partials[kBlocks][kSums];  // rank 0's: every block's sums
  __shared__ float sums[kSums];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  {  // this cluster's lane: every pointer moves to its slice
    const long long lane = blockIdx.x / kBlocks;
    source_local += lane * 3 * Q;
    plane_origin += lane * 3 * Q;
    plane_normal += lane * 3 * Q;
    valid += lane * Q;
    t_in += lane * t_stride;
    q_in += lane * q_stride;
    if (guess_t != nullptr) guess_t += lane * 3;
    H_out += lane * 36;
    b_out += lane * 6;
    if (pose_out != nullptr) pose_out += lane * 8;
    if (active != nullptr && active[lane] == 0) {
      // a finished lane: its pose and step norm stay as they are (where a
      // pose is written at all). The whole cluster leaves here, before the
      // barrier's first phase.
      if (rank == 0 && threadIdx.x == 0 && pose_out != nullptr)
        keep_pose(t_in, q_in, norm_in[lane * norm_stride], pose_out);
      return;
    }
  }
  // the cluster barrier's first phase: once it completes every block has
  // started, so distributed shared memory may be written; its wait comes
  // after the rows, which hides its latency
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // every input that does not depend on another, loaded at once: the pose,
  // the guess and the thread's first two rows
  const int stride = kBlocks * kThreads;
  const int i0 = (int)rank * kThreads + threadIdx.x;
  Row rows[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (i0 + u * stride < Q)
      rows[u] = load_row(source_local, plane_origin, plane_normal, valid, i0 + u * stride);
  const float t0 = t_in[0], t1 = t_in[1], t2 = t_in[2];
  float R[9], q[4], g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q_in[i];
  if (guess_t != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = guess_t[i];
  }
  quat_to_matrix(q, R);

  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int i = i0; i < Q; i += 2 * stride) {
    if (i > i0) {  // the next two rows, both loads out before either is used
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (i + u * stride < Q)
          rows[u] = load_row(source_local, plane_origin, plane_normal, valid, i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (i + u * stride < Q) accumulate(rows[u], R, t0, t1, t2, huber_delta, acc);
  }

  // the warp's sums by a butterfly reduce-scatter (31 shuffles for the 27
  // sums, padded to 32): lane j ends with sum j. Then the block's warps in
  // order, in shared memory.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = j < kSums ? acc[j] : 0.f;
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  if (lane < kSums) warp_sums[warp][lane] = v[0];
  __syncthreads();
  // each block stores its sums into rank 0's shared memory (distributed
  // shared memory) and arrives with release; the others are then done, and
  // rank 0 waits, then sums the blocks in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) s += warp_sums[w8][threadIdx.x];
    cluster.map_shared_rank(&partials[0][0], 0)[rank * kSums + threadIdx.x] = s;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kBlocks; ++r) s += partials[r][threadIdx.x];
    sums[threadIdx.x] = s;
  }
  __syncthreads();

  if (threadIdx.x < kSums) {
    const int j = threadIdx.x;
    if (j >= 21) {
      b_out[j - 21] = sums[j];
    } else {
      int a = 0, rem = j;  // j -> (a, c) of the row-major upper triangle
      while (rem >= 6 - a) {
        rem -= 6 - a;
        ++a;
      }
      const int c = a + rem;
      H_out[a * 6 + c] = sums[j];
      H_out[c * 6 + a] = sums[j];
    }
  }
  if (pose_out != nullptr && threadIdx.x == 0) {
    const float t[3] = {t0, t1, t2};
    step_epilogue(sums, t, q, g, prior_w, damping, pose_out);
  }
}

// The epilogue entry point: one thread per lane runs step_epilogue on a
// given H (6, 6) and b (6,) (the sums over the ranks of an sp or spatial
// group), reading the 27 sums from H's upper triangle and b in the order the
// fused kernel stores them, so on the H and b of an epilogue-off launch it
// gives the fused step's pose and step norm bit for bit.
__global__ void __launch_bounds__(32)
gn_epilogue_kernel(const float* __restrict__ H, const float* __restrict__ b,
                   const float* t_in, int t_stride, const float* q_in, int q_stride,
                   const float* norm_in, int norm_stride, const unsigned char* active,
                   const float* __restrict__ guess_t, int B, float prior_w, float damping,
                   float* pose_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  t_in += (long long)lane * t_stride;
  q_in += (long long)lane * q_stride;
  pose_out += lane * 8;
  if (active != nullptr && active[lane] == 0) {
    keep_pose(t_in, q_in, norm_in[(long long)lane * norm_stride], pose_out);
    return;
  }
  H += lane * 36;
  b += lane * 6;
  guess_t += lane * 3;
  float sums[kSums], t[3], q[4], g[3];
  int j = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) sums[j++] = H[a * 6 + c];
#pragma unroll
  for (int a = 0; a < 6; ++a) sums[21 + a] = b[a];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t_in[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q_in[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = guess_t[i];
  step_epilogue(sums, t, q, g, prior_w, damping, pose_out);
}

}  // namespace

// One launch for B lanes at the pose (t, q). Step mode: guess_t given,
// pose_out the (B, 8) floats (t, q, |delta|) of the new poses; t and q (and
// norm_in) are read at lane strides t_stride, q_stride (norm_stride), so a
// pose may be a view of an earlier step's output; active (B,) and norm_in
// may be nullptr (every lane active). Epilogue off (H and b alone, also
// the first part of a step split around a sum over ranks): guess_t,
// norm_in and pose_out nullptr, active as in step mode. H (B, 6, 6) and
// b (B, 6) are written for every active lane, before the prior and the
// damping.
// pose_out may alias t or q: every block reads the pose before it arrives at
// the cluster barrier's second phase, and rank 0 writes pose_out only after
// its wait on that phase (an inactive lane's one thread reads, then writes).
extern "C" int gn_step_launch(const void* source_local, const void* plane_origin,
                              const void* plane_normal, const void* valid,
                              const void* t, int t_stride, const void* q,
                              int q_stride, const void* norm_in, int norm_stride,
                              const void* active, const void* guess_t, int B, int Q,
                              float huber_delta, float prior_w, float damping, void* H,
                              void* b, void* pose_out, void* stream) {
  if (B == 0) return 0;
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      gn_step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (opted_in != cudaSuccess) return (int)opted_in;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kBlocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks * B, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_step_kernel, (const float*)source_local, (const float*)plane_origin,
      (const float*)plane_normal, (const unsigned char*)valid,
      (const float*)t, t_stride, (const float*)q, q_stride, (const float*)norm_in,
      norm_stride, (const unsigned char*)active, (const float*)guess_t, Q, huber_delta,
      prior_w, damping, (float*)H, (float*)b, (float*)pose_out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The epilogue alone for B lanes: H (B, 6, 6) and b (B, 6) contiguous (the
// upper triangle of H is read), t, q (and norm_in) at lane strides as in
// gn_step_launch, guess_t (B, 3), pose_out (B, 8); active and norm_in may be
// nullptr (every lane active).
extern "C" int gn_epilogue_launch(const void* H, const void* b, const void* t, int t_stride,
                                  const void* q, int q_stride, const void* norm_in,
                                  int norm_stride, const void* active, const void* guess_t,
                                  int B, float prior_w, float damping, void* pose_out,
                                  void* stream) {
  if (B == 0) return 0;
  gn_epilogue_kernel<<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)b, (const float*)t, t_stride, (const float*)q, q_stride,
      (const float*)norm_in, norm_stride, (const unsigned char*)active, (const float*)guess_t,
      B, prior_w, damping, (float*)pose_out);
  return (int)cudaGetLastError();
}
