// The step's front end: everything pipeline/odometry.py ScanStep.prepare
// computes before the two downsample sorts, for every lane of a batch, in
// four launches (kernels/prepare.py holds the plain version it is held to).
//
// Replaces no TPU kernel: the JAX package writes this part of its step as
// array code and leaves it to XLA, which fuses it into a few loops. The
// port's plain composition of the same functions (ops/preprocess.py,
// ops/classifier.py, ops/se3.py, voxel_map.pack_keys / voxel_indices) runs
// as about 430 PyTorch kernels a scan, each moving under 0.4 MB and each bound
// by its launch and latency (~1.9 us on the H100).
//
// What it computes, per lane:
//   1. the pose algebra: relative = previous^-1 o current, the deskew's start
//      pose relative^-1, and the guess current o relative;
//   2. the time range over the valid points (an all-equal scan keeps 1);
//   3. the per-point deskew: slerp from the start rotation to the identity
//      (with its lerp branch), rotation, then the translation, forward or
//      with the reference's backwards formula (`forward`);
//   4. each valid point's range-image cell, col = floor(|(atan2(-y, x) + pi)
//      W / 2pi|) by an IEEE division; the last point in input order wins a
//      cell (an atomicMax of the point index, so the order of the threads
//      does not matter); invalid points and rings outside [0, R) go nowhere;
//   5. the curvature over the flattened image, its +-kc window crossing ring
//      boundaries; range^2 < min_valid_range_sq and the first and last kc
//      cells get the invalid value;
//   6. the normal from the previous ring's first flat-enough neighbour on
//      each side (columns c-kn .. c-1 ascending, c+kn .. c+1 descending), the
//      planar mask, the range filter and the lane's planar count;
//   7. both downsample grids' packed keys (zero origin; EMPTY_KEY where
//      invalid or out of the 11/11/9-bit window);
//   8. the deskewed points, which the caller returns where it asks for them.
//
// Numbers. Every operation is the plain path's, in its order, rounded where
// PyTorch's one-operation kernels round: products, sums and quotients go
// through __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so that nvcc does
// not contract them into FMAs, and the transcendental functions are the
// CUDA math library's (atan2f, acosf, sinf, sqrtf), as PyTorch's kernels
// call them. A torch.sum over a last axis of 3 or 4 is added in the order
// PyTorch's reduction kernel adds it on the card (sum3, sum4). Thresholds
// arrive as float32, cast from the Python doubles as PyTorch casts a scalar
// operand. The slerp's dot product, arccos and sine depend on the lane alone
// and are computed once per lane, with the same arguments.
//
// Bound on Hopper: device-memory bytes. A lane reads its raw scan (21 bytes a
// point) and writes the image's points, normals, mask and two key arrays (33
// bytes a cell): ~1.64 MB at N = 32,768 and 16 x 1800 cells, 0.49 us at
// 3.35 TB/s (13 MB, 3.9 us for 8 lanes). The deskewed points, the winners
// and the image between the passes (~0.5 MB a lane) stay in the 50 MB L2.
//
// Design. The dependencies set four launches, the same for any B, each
// covering every lane (the lane is blockIdx.y, or the block in pass 1):
//   pass 1, a block per lane: the time range (a block reduction), then one
//     thread's pose algebra and slerp constants; the lane's winner image set
//     to -1 and its planar count to 0;
//   pass 2, a thread per point: normalized time, deskew, cell, atomicMax;
//   pass 3, a thread per image cell: the cell's point from its winner, with
//     a +-kc halo of cells in shared memory, and the curvature, kept as two
//     flag bits (flat, flat enough for a neighbour);
//   pass 4, a thread per image cell: the previous ring's neighbours read
//     from L2, the normal, the masks, the keys, and one atomicAdd a block.
// Against the launch floor (~2 us a launch inside a CUDA graph) the front end
// then costs four launches where it cost ~430.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // passes 2-4: a thread per point or image cell
constexpr int kLaneThreads = 1024;  // pass 1: a block per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyKey = 0x7FFFFFFF;
// key packing of ops/voxel_map.py (kernels/search.py): x [20..30], y [9..19], z [0..8]
constexpr int kYB = 11, kZB = 9;
constexpr int kXOff = 1 << 10, kYOff = 1 << 10, kZOff = 1 << 8;
constexpr int kXLim = (1 << 11) - 1, kYLim = (1 << 11) - 1, kZLim = (1 << 9) - 1;
constexpr float kBig = 1.0e9f;                          // preprocess._BIG
constexpr float kClose = (float)(1.0 - 1e-7);           // se3.quat_slerp's lerp branch
constexpr float kNormEps = (float)1e-12;                // se3.quat_normalize's eps

struct Params {
  int N, R, W;
  int kc, kn;    // curvature and normals windows
  int forward;   // deskew_forward_translation
  float pi, two_pi, curv_scale;  // math.pi, 2 pi, 2 kc + 1
  float min_valid_range_sq, invalid_curv, flat_thr, neigh_thr;
  float min_r2, max_r2;          // the range filter's squared bounds
  float vs_upd, vs_match;        // the two downsample grids' voxel sizes
};

// what pass 1 leaves for the later passes, per lane
struct LanePar {
  float tmin, rng;
  float st[3], sq[4];  // the deskew's start pose, inverse(relative)
  float d, theta, safe_sin;
  int close;
};
static_assert(sizeof(LanePar) <= 64, "the wrapper gives a lane 16 floats");

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.sum over a last axis of 3 or 4 on the card: two threads share the
// axis, each adding its even or odd elements, and a shuffle adds the two
// (measured on the H100 with torch 2.11: every other order differs)
__device__ __forceinline__ float sum3(float a, float b, float c) { return radd(radd(a, c), b); }
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return radd(radd(a, c), radd(b, d));
}

__device__ __forceinline__ float sumsq(V3 v) {
  return sum3(rmul(v.x, v.x), rmul(v.y, v.y), rmul(v.z, v.z));
}

__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {rsub(a.x, b.x), rsub(a.y, b.y), rsub(a.z, b.z)};
}

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

// se3.quat_mul, each component's terms added left to right
__device__ __forceinline__ Q4 quat_mul(Q4 a, Q4 b) {
  return {rsub(rsub(rsub(rmul(a.w, b.w), rmul(a.x, b.x)), rmul(a.y, b.y)), rmul(a.z, b.z)),
          rsub(radd(radd(rmul(a.w, b.x), rmul(a.x, b.w)), rmul(a.y, b.z)), rmul(a.z, b.y)),
          radd(radd(rsub(rmul(a.w, b.y), rmul(a.x, b.z)), rmul(a.y, b.w)), rmul(a.z, b.x)),
          radd(rsub(radd(rmul(a.w, b.z), rmul(a.x, b.y)), rmul(a.y, b.x)), rmul(a.z, b.w))};
}

struct Pose {
  V3 t;
  Q4 q;
};

__device__ __forceinline__ Pose inverse(Pose p) {  // se3.inverse
  const Q4 qi = {p.q.w, -p.q.x, -p.q.y, -p.q.z};
  return {quat_rotate(qi, {-p.t.x, -p.t.y, -p.t.z}), qi};
}

__device__ __forceinline__ Pose compose(Pose a, Pose b) {  // se3.compose: a o b
  const V3 r = quat_rotate(a.q, b.t);
  return {{radd(a.t.x, r.x), radd(a.t.y, r.y), radd(a.t.z, r.z)}, quat_mul(a.q, b.q)};
}

__device__ __forceinline__ Pose load_pose(const float* t, const float* q) {
  return {{t[0], t[1], t[2]}, {q[0], q[1], q[2], q[3]}};
}

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// pack_keys(voxel_indices(o, vs), 0, keep): truncation toward zero of an
// IEEE quotient, the 11/11/9-bit window, EMPTY_KEY outside it or where not kept
__device__ __forceinline__ int voxel_key(V3 o, float vs, bool keep) {
  const int rx = (int)((unsigned)(int)truncf(rdiv(o.x, vs)) + (unsigned)kXOff);
  const int ry = (int)((unsigned)(int)truncf(rdiv(o.y, vs)) + (unsigned)kYOff);
  const int rz = (int)((unsigned)(int)truncf(rdiv(o.z, vs)) + (unsigned)kZOff);
  const bool in = rx >= 0 && rx < kXLim && ry >= 0 && ry < kYLim && rz >= 0 && rz < kZLim;
  return keep && in ? (rx << (kYB + kZB)) | (ry << kZB) | rz : kEmptyKey;
}

// pass 1: the lane's time range, pose algebra and slerp constants
__global__ void __launch_bounds__(kLaneThreads)
lane_kernel(const float* __restrict__ time, const uint8_t* __restrict__ valid,
            const float* __restrict__ prev_t, const float* __restrict__ prev_q,
            const float* __restrict__ cur_t, const float* __restrict__ cur_q, Params p,
            LanePar* __restrict__ par, int* __restrict__ winner, int* __restrict__ num_planar,
            float* __restrict__ guess_t, float* __restrict__ guess_q) {
  __shared__ float s_lo[kLaneThreads / 32], s_hi[kLaneThreads / 32];
  const int b = blockIdx.x;
  const long long base = (long long)b * p.N;
  float lo = kBig, hi = -kBig;  // amin / amax over where(valid, t, +-_BIG)
  for (int i = threadIdx.x; i < p.N; i += kLaneThreads) {
    const bool v = valid[base + i];
    const float t = time[base + i];
    lo = fminf(lo, v ? t : kBig);
    hi = fmaxf(hi, v ? t : -kBig);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  const int RW = p.R * p.W;
  int* win = winner + (long long)b * RW;
  for (int c = threadIdx.x; c < RW; c += kLaneThreads) win[c] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kLaneThreads / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  LanePar L;
  L.tmin = lo;
  const float rng = rsub(hi, lo);
  L.rng = rng > 0.0f ? rng : 1.0f;

  const Pose prev = load_pose(prev_t + 3 * b, prev_q + 4 * b);
  const Pose cur = load_pose(cur_t + 3 * b, cur_q + 4 * b);
  const Pose rel = compose(inverse(prev), cur);
  const Pose start = inverse(rel);
  const Pose guess = compose(cur, rel);
  L.st[0] = start.t.x, L.st[1] = start.t.y, L.st[2] = start.t.z;
  L.sq[0] = start.q.w, L.sq[1] = start.q.x, L.sq[2] = start.q.y, L.sq[3] = start.q.z;
  // se3.quat_slerp(start.q, identity, t): what depends on the lane alone
  const float d = sum4(rmul(start.q.w, 1.0f), rmul(start.q.x, 0.0f), rmul(start.q.y, 0.0f),
                       rmul(start.q.z, 0.0f));
  const float abs_d = fabsf(d);
  L.d = d;
  L.close = abs_d >= kClose;
  L.theta = acosf(fminf(fmaxf(abs_d, -1.0f), 1.0f));
  L.safe_sin = L.close ? 1.0f : sinf(L.theta);
  par[b] = L;
  num_planar[b] = 0;
  guess_t[3 * b] = guess.t.x, guess_t[3 * b + 1] = guess.t.y, guess_t[3 * b + 2] = guess.t.z;
  guess_q[4 * b] = guess.q.w, guess_q[4 * b + 1] = guess.q.x;
  guess_q[4 * b + 2] = guess.q.y, guess_q[4 * b + 3] = guess.q.z;
}

// pass 2: a point's deskew and its cell
__global__ void __launch_bounds__(kThreads)
point_kernel(const float* __restrict__ xyz, const int* __restrict__ ring,
             const float* __restrict__ time, const uint8_t* __restrict__ valid, Params p,
             const LanePar* __restrict__ par, float* __restrict__ desk,
             int* __restrict__ winner) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.N) return;
  const int b = blockIdx.y;
  const LanePar L = par[b];
  const long long k = (long long)b * p.N + i;
  const float tn = rdiv(rsub(time[k], L.tmin), L.rng);  // preprocess.time_normalize
  // se3.quat_slerp(start.q, identity, tn), then se3.quat_normalize
  const float omt = rsub(1.0f, tn);
  const float s0 = L.close ? omt : rdiv(sinf(rmul(omt, L.theta)), L.safe_sin);
  float s1 = L.close ? tn : rdiv(sinf(rmul(tn, L.theta)), L.safe_sin);
  s1 = L.d < 0.0f ? -s1 : s1;
  const Q4 qs = {radd(rmul(s0, L.sq[0]), rmul(s1, 1.0f)), radd(rmul(s0, L.sq[1]), rmul(s1, 0.0f)),
                 radd(rmul(s0, L.sq[2]), rmul(s1, 0.0f)), radd(rmul(s0, L.sq[3]), rmul(s1, 0.0f))};
  const float n = fmaxf(sqrtf(sum4(rmul(qs.w, qs.w), rmul(qs.x, qs.x), rmul(qs.y, qs.y),
                                   rmul(qs.z, qs.z))), kNormEps);
  const Q4 q = {rdiv(qs.w, n), rdiv(qs.x, n), rdiv(qs.y, n), rdiv(qs.z, n)};
  const V3 rot = quat_rotate(q, load3(xyz, k));
  // preprocess.deskew's translation, start.t w_start + 0 (1 - w_start)
  const float ws = p.forward ? rsub(1.0f, tn) : tn;
  const float we = rsub(1.0f, ws);
  const V3 out = {radd(rot.x, radd(rmul(L.st[0], ws), rmul(0.0f, we))),
                  radd(rot.y, radd(rmul(L.st[1], ws), rmul(0.0f, we))),
                  radd(rot.z, radd(rmul(L.st[2], ws), rmul(0.0f, we)))};
  store3(desk, k, out);
  if (!valid[k]) return;
  // classifier.organize's cell
  const float az = radd(atan2f(-out.y, out.x), p.pi);
  const int col = (int)floorf(fabsf(rdiv(rmul(az, (float)p.W), p.two_pi)));
  const int r = ring[k];
  if (col < p.W && r >= 0 && r < p.R)
    atomicMax(winner + (long long)b * p.R * p.W + r * p.W + col, i);
}

// pass 3: the image's points and their curvature flags (bit 0: flat, bit 1:
// flat enough for a neighbour)
__global__ void __launch_bounds__(kThreads)
image_kernel(const int* __restrict__ winner, const float* __restrict__ desk, Params p,
             float* __restrict__ img, uint8_t* __restrict__ flags) {
  extern __shared__ float s_xyz[];  // (kThreads + 2 kc) cells x 3
  const int b = blockIdx.y;
  const int RW = p.R * p.W, kc = p.kc;
  const int f0 = blockIdx.x * kThreads;
  const int* win = winner + (long long)b * RW;
  const float* pts = desk + (long long)b * p.N * 3;
  for (int j = threadIdx.x; j < kThreads + 2 * kc; j += kThreads) {
    const int f = f0 - kc + j;
    V3 v = {0.0f, 0.0f, 0.0f};  // an empty cell, or beyond the image's ends
    if (f >= 0 && f < RW) {
      const int w = win[f];
      if (w >= 0) v = load3(pts, w);
    }
    store3(s_xyz, j, v);
  }
  __syncthreads();
  const int i = f0 + threadIdx.x;
  if (i >= RW) return;
  const int j = threadIdx.x + kc;
  const V3 pi = load3(s_xyz, j);
  // classifier.curvature: -9 p_i, then p_{i-kc} .. p_{i+kc} added in order
  V3 acc = {rmul(-pi.x, p.curv_scale), rmul(-pi.y, p.curv_scale), rmul(-pi.z, p.curv_scale)};
  for (int w = -kc; w <= kc; ++w) {
    const V3 q = load3(s_xyz, j + w);
    acc = {radd(acc.x, q.x), radd(acc.y, q.y), radd(acc.z, q.z)};
  }
  const float range_sq = sumsq(pi);
  float curv = rdiv(sqrtf(sumsq(acc)), range_sq > 0.0f ? range_sq : 1.0f);
  if (range_sq < p.min_valid_range_sq || i < kc || i >= RW - kc) curv = p.invalid_curv;
  const long long c = (long long)b * RW + i;
  store3(img, c, pi);
  flags[c] = (curv < p.flat_thr ? 1 : 0) | (curv < p.neigh_thr ? 2 : 0);
}

// pass 4: normals, the planar mask, the range filter, the keys and the count
__global__ void __launch_bounds__(kThreads)
planar_kernel(const float* __restrict__ img, const uint8_t* __restrict__ flags, Params p,
              float* __restrict__ normal, uint8_t* __restrict__ out_valid,
              int* __restrict__ keys_upd, int* __restrict__ keys_match,
              int* __restrict__ num_planar) {
  const int b = blockIdx.y;
  const int RW = p.R * p.W, kn = p.kn;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool keep = false;
  if (i < RW) {
    const float* im = img + (long long)b * RW * 3;
    const uint8_t* fl = flags + (long long)b * RW;
    const int r = i / p.W, c = i - r * p.W;
    const V3 o = load3(im, i);
    V3 n = {0.0f, 0.0f, 0.0f};
    bool planar = false;
    if (r >= 1 && c >= kn && c < p.W - kn) {  // classifier._in_window
      // classifier._first_flat_neighbor on the previous ring, each side
      // scanned from the outside in; a side with none keeps (0, 0, 0)
      const int prev = i - p.W;
      V3 left = {0.0f, 0.0f, 0.0f}, right = {0.0f, 0.0f, 0.0f};
      bool lf = false, rf = false;
      for (int off = -kn; off <= -1 && !lf; ++off) {
        if (fl[prev + off] & 2) {
          left = load3(im, prev + off);
          lf = true;
        }
      }
      for (int off = kn; off >= 1 && !rf; --off) {
        if (fl[prev + off] & 2) {
          right = load3(im, prev + off);
          rf = true;
        }
      }
      const V3 cr = cross(vsub(left, o), vsub(right, o));
      const float nn = sqrtf(sumsq(cr));
      const float den = nn > 0.0f ? nn : 1.0f;
      n = {rdiv(cr.x, den), rdiv(cr.y, den), rdiv(cr.z, den)};
      planar = (fl[i] & 1) && lf && rf && nn > 0.0f;
    }
    const float sq = sumsq(o);  // preprocess.range_filter_mask
    keep = planar && sq >= p.min_r2 && sq <= p.max_r2;
    const long long cell = (long long)b * RW + i;
    store3(normal, cell, n);
    out_valid[cell] = keep;
    keys_upd[cell] = voxel_key(o, p.vs_upd, keep);
    keys_match[cell] = voxel_key(o, p.vs_match, keep);
  }
  const int count = __syncthreads_count(keep);
  if (threadIdx.x == 0 && count > 0) atomicAdd(num_planar + b, count);
}

}  // namespace

extern "C" int prepare_launch(
    const float* xyz, const int* ring, const float* time, const uint8_t* valid,
    const float* prev_t, const float* prev_q, const float* cur_t, const float* cur_q,
    int B, int N, int R, int W, int kc, int kn, int forward, float pi, float two_pi,
    float curv_scale, float min_valid_range_sq, float invalid_curv, float flat_thr,
    float neigh_thr, float min_r2, float max_r2, float vs_upd, float vs_match,
    float* lane_par, int* winner, uint8_t* flags, float* desk, float* img, float* normal,
    uint8_t* out_valid, int* keys_upd, int* keys_match, int* num_planar, float* guess_t,
    float* guess_q, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Params p = {N, R, W, kc, kn, forward, pi, two_pi, curv_scale, min_valid_range_sq,
                    invalid_curv, flat_thr, neigh_thr, min_r2, max_r2, vs_upd, vs_match};
  LanePar* par = reinterpret_cast<LanePar*>(lane_par);
  lane_kernel<<<B, kLaneThreads, 0, stream>>>(time, valid, prev_t, prev_q, cur_t, cur_q, p, par,
                                              winner, num_planar, guess_t, guess_q);
  if (N > 0)
    point_kernel<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        xyz, ring, time, valid, p, par, desk, winner);
  const int RW = R * W;
  if (RW > 0) {
    const dim3 grid((RW + kThreads - 1) / kThreads, B);
    const size_t smem = sizeof(float) * 3 * (kThreads + 2 * kc);
    image_kernel<<<grid, kThreads, smem, stream>>>(winner, desk, p, img, flags);
    planar_kernel<<<grid, kThreads, 0, stream>>>(img, flags, p, normal, out_valid, keys_upd,
                                                 keys_match, num_planar);
  }
  return (int)cudaGetLastError();
}
