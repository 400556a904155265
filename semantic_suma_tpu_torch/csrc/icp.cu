// Kernels D, E and F: frame-to-model projective ICP's Gauss-Newton loop
// (ops/icp.py). F runs a whole gauss_newton call in one launch; D and E are
// one iteration's two halves, held against F bit for bit.
//
// Replace the body of the JAX package's gauss_newton while_loop
// (semantic_suma_tpu/ops/icp.py:251-309): build_rows (:142), the
// jnp.dot(rows.T, rows) reduction, _solve_spd (:240) and the stop test
// (:274-287). XLA fuses the row build into the product there; these are
// hand-written stages of that XLA program, not of a Pallas kernel.
//
// D (icp_products_kernel): one thread a data pixel. It transforms the
// pixel by the pose in device memory, projects it into the model image
// (atan2f, asinf), samples the packed [H*W, 8] model image (nearest tap, or
// bilinear geometry with the horizontal wrap, the vertical clamp and the
// nearest tap's label), gates the pair (inside, valid, max_distance,
// max_angle), weighs it (huber; turkey, which reads the iteration counter
// k from device memory; or none; times the semantic weight) and forms its
// row [sqrt(w) n_m, sqrt(w) v_d x n_m, sqrt(w) r]. The block sums the 27
// products the solve needs (the lower triangle of A^T A[0:6, 0:6] and
// A^T A[0:6, 6]) and the six IcpStats sums by warp shuffles in a fixed
// order, and writes them as one row of a [blocks, 33] buffer of partial
// sums: no float atomics, so that two runs of the same scans give the same
// bits. The per-pixel arithmetic repeats the plain PyTorch version's
// operations one rounding at a time (the _rn intrinsics, which nvcc does
// not contract into FMAs, and fmaf where the plain version's kernels fuse),
// so that the projection's truncation, the sample and the gates, which
// decide the integer counters, see the values the plain version sees on
// the card.
// E (gn_update_kernel): one block. It sums the partials in a fixed order
// (lane-strided in double, then a fixed shuffle tree), solves the 6x6
// system by Cholesky with _solve_spd's Tikhonov floor (NaN where the
// factorization fails, as the JAX Cholesky gives), runs the stop test,
// applies se3_exp(delta) @ pose (the old pose on a non-finite step), and
// writes the pose, last_err, the statistics, k + 1 and the latch `done`.
// Both return at once when `done` is set.
//
// F (gn_loop_kernel): the whole loop in one cooperative launch, as the
// reference's while_loop is one device program. Its blocks take the place
// of the devices of the reference's psum over `axis` (:262-267): each
// iteration every block writes the partial sums of its slots (D's
// partition: slot s is D's block s, so every partial has D's bits), one
// grid barrier stands for the psum, and then every block sums all the
// slots in E's order and runs E's solve and update itself on a copy of the
// state in its shared memory. All blocks hold the same state bit for bit,
// take the same stop decision and leave the loop together; block 0 writes
// the state back. The partials go to a ping-pong buffer [2, 33, slots]
// (a column's slots side by side, so that a warp's loads of them
// coalesce): a block can write iteration t + 2's half only after the
// barrier of t + 1, which waits for every block to finish reading
// iteration t's, so one barrier an iteration is enough. E's solve is one
// __noinline__ function that E and F both call, D's slot sum and E's sum
// one inlined function each, so that the two routes compile the same
// arithmetic. An iteration at 64x900 takes ~8.9 us on an H100 80GB HBM3 at
// 700 W (tools/gn_loop_designs.py; PERF.md): the barrier ~1.2, the slot
// work ~3.4, every block's sum of the 225 x 33 partials under 0.1 and the
// one thread's solve ~4.3 us. Block 0 solving alone behind a second
// barrier took ~9.1 us; slot-major partials read one load at a time a
// lane, ~28 us.
//
// Bound on an H100: the bytes, far under the launch floor. A live D reads
// per data pixel its vertex and normal (24 B), two valid bytes, label and
// probability (8 B) and one (nearest) or four (bilinear) 32-byte model
// rows: ~66 B a pixel, ~3.8 MB at 64x900, ~1.1 us at 3.35 TB/s; E reads
// 33 floats a block. What holds them is latency: D's dependent chain
// (pose, transform, projection, model gather, reduction) and, for D and E,
// a launch each; F pays one launch a call and one grid barrier an
// iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int NPART = 33;     // partial sums a block (ops/icp.py NPART)
constexpr int NTRI = 21;      // lower triangle of the 6x6 J^T W J
constexpr int THREADS = 256;  // D, F: one thread a pixel; E: one block
constexpr int WARPS = THREADS / 32;
// state_f: pose [0:16], last_err 16, error 17, inlier_residual 18
constexpr int SF = 20, SF_LAST = 16, SF_ERR = 17, SF_INRES = 18;
// state_i: k 0, done 1, valid 2, inlier 3, outlier 4, invalid 5
constexpr int SI = 8, SI_K = 0, SI_DONE = 1, SI_COUNTS = 2;

struct DParams {
  const float* vertex;   // [P, 3]
  const float* normal;   // [P, 3]
  const uint8_t* vvalid; // [P]
  const uint8_t* nvalid; // [P]
  const int* label;      // [P]
  const float* prob;     // [P]
  const float4* model;   // [MH * MW, 8] as float4 pairs
  const float* state_f;  // D only
  const int* state_i;    // D only
  float* partials;       // D: [gridDim.x, NPART]; F: [2, NPART, slots]
  int p, mh, mw;
  int weighting;         // 0 none, 1 huber, 2 turkey
  int bilinear, semantic;
  unsigned long long movable;  // bit c: class c < 64 is movable
  float fmw, fmh, fov_up, inv_fov, deg, inv_pi;
  float max_dist, angle_thr, factor, inv_factor;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// sum of the three products, rounded one operation at a time (torch.sum of
// an elementwise product over the last dim)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__device__ __forceinline__ float norm3(float a0, float a1, float a2) {
  return sqrtf(fmaf(a2, a2, fmaf(a1, a1, mul(a0, a0))));
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.remainder of integers: the result takes the divisor's sign
__device__ __forceinline__ long long pymod(long long a, long long m) {
  long long r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ void load_row(const float4* model, long long idx,
                                         float g[8]) {
  const float4 a = __ldg(model + 2 * idx);
  const float4 b = __ldg(model + 2 * idx + 1);
  g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
  g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
}

// One pixel's row and statistics; acc gets its products and sums.
__device__ __forceinline__ void pixel(const DParams& q, int i,
                                      const float* pose, int k,
                                      float acc[NPART]) {
  const bool dvalid = q.vvalid[i] && q.nvalid[i];
  const float x = q.vertex[3 * i], y = q.vertex[3 * i + 1],
              z = q.vertex[3 * i + 2];
  const float nx = q.normal[3 * i], ny = q.normal[3 * i + 1],
              nz = q.normal[3 * i + 2];
  // v_d = v @ R^T + t, n_d = n @ R^T (a [P,3] x [3,3] product: k in order)
  float vd[3], nd[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* pr = pose + 4 * r;
    vd[r] = add(fmaf(z, pr[2], fmaf(y, pr[1], mul(x, pr[0]))), pr[3]);
    nd[r] = fmaf(nz, pr[2], fmaf(ny, pr[1], mul(nx, pr[0])));
  }
  // _project_to_model
  const float depth = __fsqrt_rn(
      add(add(mul(vd[0], vd[0]), mul(vd[1], vd[1])), mul(vd[2], vd[2])));
  const float yaw = atan2f(vd[1], vd[0]);
  float s = __fdiv_rn(vd[2], fmaxf(depth, 1e-12f));
  s = isnan(s) ? s : fminf(fmaxf(s, -1.0f), 1.0f);
  const float pitch = -asinf(s);
  const float u = mul(mul(0.5f, add(mul(-yaw, q.inv_pi), 1.0f)), q.fmw);
  const float v = mul(sub(1.0f, mul(add(mul(pitch, q.deg), q.fov_up),
                                    q.inv_fov)), q.fmh);
  const bool inside = u >= 0.0f && u < q.fmw && v >= 0.0f && v < q.fmh;

  // _sample_model
  float vm[3], nraw[3];
  bool mvalid;
  int mlabel;
  if (!q.bilinear) {
    const long long xi = clampll((long long)u, 0, q.mw - 1);
    const long long yi = clampll((long long)v, 0, q.mh - 1);
    float g[8];
    load_row(q.model, yi * q.mw + xi, g);
    vm[0] = g[0]; vm[1] = g[1]; vm[2] = g[2];
    nraw[0] = g[3]; nraw[1] = g[4]; nraw[2] = g[5];
    mvalid = g[6] > 0.5f;
    mlabel = (int)g[7];
  } else {
    const float xf = sub(u, 0.5f), yf = sub(v, 0.5f);
    const float x0 = floorf(xf), y0 = floorf(yf);
    const float ax = sub(xf, x0), ay = sub(yf, y0);
    const long long x0i = pymod((long long)x0, q.mw);
    const long long x1i = pymod(x0i + 1, q.mw);
    const long long y0i = clampll((long long)y0, 0, q.mh - 1);
    const long long y1i = clampll(y0i + 1, 0, q.mh - 1);
    float g00[8], g10[8], g01[8], g11[8];
    load_row(q.model, y0i * q.mw + x0i, g00);
    load_row(q.model, y0i * q.mw + x1i, g10);
    load_row(q.model, y1i * q.mw + x0i, g01);
    load_row(q.model, y1i * q.mw + x1i, g11);
    const float omx = sub(1.0f, ax), omy = sub(1.0f, ay);
    float samp[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const float top = add(mul(g00[c], omx), mul(g10[c], ax));
      const float bot = add(mul(g01[c], omx), mul(g11[c], ax));
      samp[c] = add(mul(top, omy), mul(bot, ay));
    }
    vm[0] = samp[0]; vm[1] = samp[1]; vm[2] = samp[2];
    nraw[0] = samp[3]; nraw[1] = samp[4]; nraw[2] = samp[5];
    mvalid = samp[6] > 0.999f;  // all four taps valid
    const bool right = ax > 0.5f, down = ay > 0.5f;
    const float lt = right ? g10[7] : g00[7];
    const float lb = right ? g11[7] : g01[7];
    mlabel = (int)(down ? lb : lt);
  }
  const float nn = fmaxf(norm3(nraw[0], nraw[1], nraw[2]), 1e-12f);
  const float nm[3] = {__fdiv_rn(nraw[0], nn), __fdiv_rn(nraw[1], nn),
                       __fdiv_rn(nraw[2], nn)};

  const bool assoc = dvalid && inside && mvalid;
  const float d[3] = {sub(vd[0], vm[0]), sub(vd[1], vm[1]),
                      sub(vd[2], vm[2])};
  const float residual = dot3(nm[0], nm[1], nm[2], d[0], d[1], d[2]);
  const float dist = norm3(d[0], d[1], d[2]);
  const float ndot = dot3(nm[0], nm[1], nm[2], nd[0], nd[1], nd[2]);
  const bool inlier = assoc && dist <= q.max_dist && ndot >= q.angle_thr;

  const float absr = fabsf(residual);
  float weight = 1.0f;
  if (q.weighting == 1) {
    weight = absr > q.factor
                 ? mul(__frcp_rn(fmaxf(absr, 1e-12f)), q.factor) : 1.0f;
  } else if (q.weighting == 2) {
    const float alpha = mul(residual, q.inv_factor);
    const float t = sub(1.0f, mul(alpha, alpha));
    weight = absr > q.factor ? 0.0f : (k > 0 ? mul(t, t) : 1.0f);
  }
  if (q.semantic) {
    const bool movable = mlabel >= 0 && mlabel < 64
                         && ((q.movable >> mlabel) & 1ull);
    const float pr = q.prob[i];
    const float semw = movable ? (q.label[i] == mlabel ? pr : sub(1.0f, pr))
                               : 1.0f;
    weight = mul(weight, semw);
  }
  // a*b - c*d as nvcc contracts it, written out so that D and F cannot
  // contract it differently
  const float cp[3] = {fmaf(vd[1], nm[2], -mul(vd[2], nm[1])),
                       fmaf(vd[2], nm[0], -mul(vd[0], nm[2])),
                       fmaf(vd[0], nm[1], -mul(vd[1], nm[0]))};
  const float sw = sqrtf(fmaxf(weight, 0.0f));
  const float m = inlier ? 1.0f : 0.0f;
  const float row[7] = {
      mul(mul(sw, nm[0]), m), mul(mul(sw, nm[1]), m), mul(mul(sw, nm[2]), m),
      mul(mul(sw, cp[0]), m), mul(mul(sw, cp[1]), m), mul(mul(sw, cp[2]), m),
      mul(mul(sw, residual), m)};
  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b, ++t) acc[t] = fmaf(row[a], row[b], acc[t]);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[NTRI + a] = fmaf(row[a], row[6], acc[NTRI + a]);
  const float wr2 = mul(mul(weight, residual), residual);
  if (assoc) acc[27] += wr2;
  if (inlier) acc[28] += wr2;
  acc[29] += assoc ? 1.0f : 0.0f;
  acc[30] += inlier ? 1.0f : 0.0f;
  acc[31] += (assoc && !inlier) ? 1.0f : 0.0f;
  acc[32] += (dvalid && !assoc) ? 1.0f : 0.0f;
}

// Slot s of `nslots` (the pixels s * THREADS + tid, stepping by nslots *
// THREADS) at `pose` (shared memory) and iteration k: its NPART sums, by
// warp shuffles and then the warps in order, to out[j * stride]. Every
// thread of the block calls it; the caller syncs before `warp_sums` is
// reused.
__device__ __forceinline__ void slot_sums(const DParams& q, int s,
                                          int nslots, const float* pose,
                                          int k, float (*warp_sums)[NPART],
                                          float* out, int stride) {
  float acc[NPART];
#pragma unroll
  for (int j = 0; j < NPART; ++j) acc[j] = 0.0f;
  for (int i = s * THREADS + threadIdx.x; i < q.p; i += nslots * THREADS)
    pixel(q, i, pose, k, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NPART; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NPART) {
    float v = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += warp_sums[w][threadIdx.x];
    out[threadIdx.x * stride] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
icp_products_kernel(const DParams q) {
  if (q.state_i[SI_DONE]) return;  // latched: the loop has stopped
  __shared__ float pose[16];
  __shared__ float warp_sums[WARPS][NPART];
  if (threadIdx.x < 16) pose[threadIdx.x] = q.state_f[threadIdx.x];
  __syncthreads();
  slot_sums(q, blockIdx.x, gridDim.x, pose, q.state_i[SI_K], warp_sums,
            q.partials + blockIdx.x * NPART, 1);
}

// lie.se3_exp of a twist [v, omega] as a 4x4 (row-major, last row 0 0 0 1)
__device__ void se3_exp(const float x[6], float out[16]) {
  const float o0 = x[3], o1 = x[4], o2 = x[5];
  const float theta2 = o0 * o0 + o1 * o1 + o2 * o2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : sn / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (theta - sn) / (theta2 * theta);
  const float kk[3][3] = {{0.0f, -o2, o1}, {o2, 0.0f, -o0}, {-o1, o0, 0.0f}};
  float k2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      k2[i][j] = kk[i][0] * kk[0][j] + kk[i][1] * kk[1][j]
                 + kk[i][2] * kk[2][j];
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.0f : 0.0f;
      out[4 * i + j] = id + a * kk[i][j] + b * k2[i][j];
      t += (id + b * kk[i][j] + c * k2[i][j]) * x[j];  // V v
    }
    out[4 * i + 3] = t;
  }
  out[12] = out[13] = out[14] = 0.0f;
  out[15] = 1.0f;
}

// The slots' sums in E's fixed order, the sum of slot b's column c at
// partials[b * sb + c * sc]: warp w takes the columns w, w + WARPS, ...;
// for each, lane l adds the slots l, l + 32, ... in double in that order,
// then a shuffle tree. The loads of a lane's columns and 8 of its slots are
// issued before their adds, which keep the order. Every thread of the block
// calls it. Loads through L2 (ld.global.cg): in F other blocks wrote the
// sums in this launch, so neither the read-only path nor a stale L1 line
// may serve them.
__device__ __forceinline__ void sum_partials(const float* partials,
                                             int nslots, int sb, int sc,
                                             double* sums) {
  constexpr int COLS = (NPART + WARPS - 1) / WARPS;
  constexpr int UNROLL = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) s[j] = 0.0;
  for (int b0 = lane; b0 < nslots; b0 += 32 * UNROLL) {
    float v[COLS][UNROLL];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = warp + j * WARPS;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int b = b0 + 32 * u;
        v[j][u] = c < NPART && b < nslots
                      ? __ldcg(partials + b * sb + c * sc) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (b0 + 32 * u < nslots) s[j] += (double)v[j][u];
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    double t = s[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
    const int c = warp + j * WARPS;
    if (lane == 0 && c < NPART) sums[c] = t;
  }
  __syncthreads();
}

// E's one thread: the solve, the stop test and the update of the state
// (sf, si: global memory in E, a block's shared copy in F) from the summed
// partials. Not inlined, so that E and F run the same instructions.
__device__ __noinline__ void gn_step(const double* sums, float* sf, int* si,
                                     float delta_thr, float stop_thr) {
  float a[6][6], jtf[6];
  int t = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) a[i][j] = (float)sums[t++];
  for (int i = 0; i < 6; ++i) jtf[i] = (float)sums[NTRI + i];
  const float err = (float)sums[27];
  const float inres = (float)sums[28];

  // _solve_spd: a + 1e-8 I max(trace / 6, 1), Cholesky, two substitutions
  float tr = a[0][0];
  for (int i = 1; i < 6; ++i) tr += a[i][i];
  const float reg = 1e-8f * fmaxf(tr * (1.0f / 6.0f), 1.0f);
  for (int i = 0; i < 6; ++i) a[i][i] += reg;
  float l[6][6];
  bool ok = true;  // every pivot positive (a NaN pivot fails too)
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float dj = a[j][j];
#pragma unroll
    for (int m = 0; m < j; ++m) dj -= l[j][m] * l[j][m];
    ok = ok && dj > 0.0f;
    l[j][j] = sqrtf(dj);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = a[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) s -= l[i][m] * l[j][m];
      l[i][j] = s / l[j][j];
    }
  }
  float delta[6], y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -jtf[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s -= l[i][m] * y[m];
    y[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s -= l[m][i] * delta[m];
    delta[i] = ok ? s / l[i][i] : CUDART_NAN_F;
  }

  bool finite = true;
  float maxabs = 0.0f, maxjtf = jtf[0];
  for (int i = 0; i < 6; ++i) {
    finite = finite && isfinite(delta[i]);
    maxabs = fmaxf(maxabs, fabsf(delta[i]));
    maxjtf = fmaxf(maxjtf, jtf[i]);
  }
  const float last = sf[SF_LAST];
  const bool stop = !finite || maxabs < delta_thr
                    || fabsf(maxjtf) < stop_thr
                    || (err < last && fabsf(err - last) < stop_thr);
  if (finite) {
    float e[16], p[16];
    se3_exp(delta, e);
    for (int i = 0; i < 16; ++i) p[i] = sf[i];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        float s = 0.0f;
        for (int m = 0; m < 4; ++m) s = fmaf(e[4 * i + m], p[4 * m + j], s);
        sf[4 * i + j] = s;
      }
  }
  sf[SF_LAST] = err;
  sf[SF_ERR] = err;
  sf[SF_INRES] = inres;
  si[SI_K] += 1;
  si[SI_DONE] = stop ? 1 : 0;
  for (int c = 0; c < 4; ++c) si[SI_COUNTS + c] = (int)llrint(sums[29 + c]);
}

__global__ void __launch_bounds__(THREADS)
gn_update_kernel(const float* partials, int nblocks, float* sf, int* si,
                 float delta_thr, float stop_thr) {
  if (si[SI_DONE]) return;  // latched
  __shared__ double sums[NPART];
  sum_partials(partials, nblocks, NPART, 1, sums);
  if (threadIdx.x == 0) gn_step(sums, sf, si, delta_thr, stop_thr);
}

// F: up to max_iter iterations from the state, ending at the stop test.
// Block b takes the slots b, b + gridDim.x, ...; launched cooperatively
// with gridDim.x <= nslots blocks, all resident at once.
__global__ void __launch_bounds__(THREADS, 2)
gn_loop_kernel(const DParams q, int nslots, int max_iter, float* state_f,
               int* state_i, float delta_thr, float stop_thr) {
  __shared__ float sf[SF];
  __shared__ int si[SI];
  __shared__ float warp_sums[WARPS][NPART];
  __shared__ double sums[NPART];
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x < SF) sf[threadIdx.x] = state_f[threadIdx.x];
  if (threadIdx.x < SI) si[threadIdx.x] = state_i[threadIdx.x];
  __syncthreads();
  for (int t = 0; t < max_iter && !si[SI_DONE]; ++t) {
    float* half = q.partials + (size_t)(t & 1) * nslots * NPART;
    const int k = si[SI_K];
    for (int s = blockIdx.x; s < nslots; s += gridDim.x) {
      slot_sums(q, s, nslots, sf, k, warp_sums, half + s, nslots);
      __syncthreads();
    }
    grid.sync();  // every slot written: the reference's psum
    sum_partials(half, nslots, 1, nslots, sums);
    if (threadIdx.x == 0) gn_step(sums, sf, si, delta_thr, stop_thr);
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < SF) state_f[threadIdx.x] = sf[threadIdx.x];
    if (threadIdx.x < SI) state_i[threadIdx.x] = si[threadIdx.x];
  }
}

DParams make_params(const void* vertex, const void* normal,
                    const void* vvalid, const void* nvalid, const void* label,
                    const void* prob, const void* model, const void* state_f,
                    const void* state_i, void* partials, int p, int mh,
                    int mw, int weighting, int bilinear, int semantic,
                    unsigned long long movable, float fov_up, float inv_fov,
                    float deg, float inv_pi, float max_dist, float angle_thr,
                    float factor, float inv_factor) {
  DParams q;
  q.vertex = static_cast<const float*>(vertex);
  q.normal = static_cast<const float*>(normal);
  q.vvalid = static_cast<const uint8_t*>(vvalid);
  q.nvalid = static_cast<const uint8_t*>(nvalid);
  q.label = static_cast<const int*>(label);
  q.prob = static_cast<const float*>(prob);
  q.model = static_cast<const float4*>(model);
  q.state_f = static_cast<const float*>(state_f);
  q.state_i = static_cast<const int*>(state_i);
  q.partials = static_cast<float*>(partials);
  q.p = p;
  q.mh = mh;
  q.mw = mw;
  q.weighting = weighting;
  q.bilinear = bilinear;
  q.semantic = semantic;
  q.movable = movable;
  q.fmw = (float)mw;
  q.fmh = (float)mh;
  q.fov_up = fov_up;
  q.inv_fov = inv_fov;
  q.deg = deg;
  q.inv_pi = inv_pi;
  q.max_dist = max_dist;
  q.angle_thr = angle_thr;
  q.factor = factor;
  q.inv_factor = inv_factor;
  return q;
}

}  // namespace

// Kernel D on `stream`: `nblocks` blocks of 256 threads over `p` data
// pixels; returns cudaGetLastError() after the launch.
extern "C" int icp_products(
    const void* vertex, const void* normal, const void* vvalid,
    const void* nvalid, const void* label, const void* prob,
    const void* model, const void* state_f, const void* state_i,
    void* partials, int p, int mh, int mw, int nblocks, int weighting,
    int bilinear, int semantic, unsigned long long movable, float fov_up,
    float inv_fov, float deg, float inv_pi, float max_dist, float angle_thr,
    float factor, float inv_factor, void* stream) {
  const DParams q = make_params(
      vertex, normal, vvalid, nvalid, label, prob, model, state_f, state_i,
      partials, p, mh, mw, weighting, bilinear, semantic, movable, fov_up,
      inv_fov, deg, inv_pi, max_dist, angle_thr, factor, inv_factor);
  icp_products_kernel<<<nblocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E on `stream`: one block of 256 threads.
extern "C" int gn_update(const void* partials, int nblocks, void* state_f,
                         void* state_i, float delta_thr, float stop_thr,
                         void* stream) {
  gn_update_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nblocks,
      static_cast<float*>(state_f), static_cast<int*>(state_i), delta_thr,
      stop_thr);
  return static_cast<int>(cudaGetLastError());
}

// Kernel F's residency on the current device: the blocks of 256 threads an
// SM holds at once and the SMs; returns a CUDA error code (not a launch:
// nothing waits for the device).
extern "C" int gn_loop_occupancy(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    int coop = 0;
    rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (rc == cudaSuccess && !coop) rc = cudaErrorNotSupported;
  }
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gn_loop_kernel, THREADS, 0);
  return static_cast<int>(rc);
}

// Kernel F on `stream`: a cooperative launch of `grid` blocks of 256
// threads (at most nslots and at most what the card holds at once) that
// runs up to max_iter iterations on the state; `partials` holds
// [2, NPART, nslots] floats. Returns the launch's error code (a grid too
// large for the card is cudaErrorCooperativeLaunchTooLarge).
extern "C" int gn_loop(
    const void* vertex, const void* normal, const void* vvalid,
    const void* nvalid, const void* label, const void* prob,
    const void* model, void* state_f, void* state_i, void* partials, int p,
    int mh, int mw, int nslots, int weighting, int bilinear, int semantic,
    unsigned long long movable, float fov_up, float inv_fov, float deg,
    float inv_pi, float max_dist, float angle_thr, float factor,
    float inv_factor, int grid, int max_iter, float delta_thr,
    float stop_thr, void* stream) {
  DParams q = make_params(
      vertex, normal, vvalid, nvalid, label, prob, model, nullptr, nullptr,
      partials, p, mh, mw, weighting, bilinear, semantic, movable, fov_up,
      inv_fov, deg, inv_pi, max_dist, angle_thr, factor, inv_factor);
  float* sf = static_cast<float*>(state_f);
  int* si = static_cast<int*>(state_i);
  void* args[] = {&q, &nslots, &max_iter, &sf, &si, &delta_thr, &stop_thr};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_loop_kernel), dim3(grid),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clear what the launch set
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}
