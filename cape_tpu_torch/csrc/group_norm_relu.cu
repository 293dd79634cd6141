// Group norm fused with the ReLU after it, for Hopper (sm_90a), forward and
// backward, batch-major x [B, V, C]:
//
//   y[b, v, c] = relu((x[b, v, c] - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c])
//
// with G groups of C/G contiguous channels, g = c / (C/G), and the
// statistics of group g of sample b over its channels and the first
// n_valid rows only (the rows past them are the padded layout's tail,
// which may hold anything, inf and NaN included: they are skipped, never
// multiplied by a mask): mean = sum / n, var = sum (x - mean)^2 / n (the
// two-pass variance, as jnp.var takes it), n = n_valid * C/G, rstd =
// 1 / sqrt(var + eps). Sums are f32; gamma and beta are rounded to x's
// dtype, as the plain version casts them; y is rounded once to x's dtype
// (f32, bf16 or f16). The tail rows of y are computed by the same formula.
//
// The backward, from the saved x, mean and rstd (no normalised copy is
// stored): x^ = (x - mean) rstd and the ReLU's mask z > 0 (z the value
// before the ReLU, recomputed as the forward computed it) are recomputed;
// dz = mask ? dy : 0, dx^ = dz gamma,
//
//   dx = rstd (dx^ - sum(dx^) / n - x^ sum(dx^ x^) / n)   on the valid rows
//   dx = rstd dx^                                          on the tail rows
//   dgamma[c] = sum_{b, valid v} dz x^,   dbeta[c] = sum_{b, valid v} dz
//
// The group sums run over the valid rows; sum(dx^) and sum(dx^ x^) of a
// group are gamma-weighted sums of the per-channel dbeta and dgamma terms.
// The padded layout's tail cotangents are zero, so the tail rows add
// nothing to dgamma and dbeta there, and a non-finite tail row cannot
// reach them. dgamma and dbeta are reduced over the batch in a fixed
// order, without atomics, so a run repeats itself bit for bit.
//
// Replaces no TPU kernel: the JAX package leaves the group norm to XLA,
// which fuses it. The port's plain version (cape_tpu_torch/ops/norm.py
// `group_norm`, then torch.relu) runs each of its ~19 forward and ~27
// backward operators as a kernel of its own, on the transposed view
// [B, C, V], where the elementwise and reduction kernels walk strided
// memory; the GraphCMR decoder runs 24 such norms a train step, which
// made them the step's largest block of launches. This kernel is one
// launch forward and two backward.
//
// What bounds it: bytes. A few operations an element against 4 (f32) or
// 2 bytes, so the least time is the forward reading x once and writing y
// once, the backward reading x and dy once and writing dx once. What the
// design does about it:
//   * A block owns sample b, k consecutive groups (W = k C/G channels, a
//     multiple of the 16-byte access and, where the groups allow, at
//     least 32 bytes a row: one sector) and a part of the rows. The p
//     blocks that share (b, groups) split the rows and form a thread
//     block cluster; they exchange their per-channel sums through
//     distributed shared memory, each reading the p partials in the same
//     order, so every block of the cluster holds the same statistics.
//   * The block's part of x (and dy) is copied into shared memory once,
//     with cp.async, all of it in flight at once, and every pass reads it
//     from there; a thread reads only the accesses it copied, so no
//     barrier guards the copy. norm_plan takes no shape whose part does
//     not fit (every GraphCMR decoder norm fits at any batch).
//   * Lanes run along the W channels with 16-byte accesses and along the
//     rows; each thread keeps the same channels over the rows, so its
//     per-channel gamma, beta and statistics sit in registers, and its
//     partial sums go through a fixed tree in shared memory.
//   * p is chosen from the part's bytes and the card's size (norm_plan
//     in ops/norm.py): about 64 KB a block and at least two blocks an SM.
//
// No library kernel is called.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cgr = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_MAX = 232448;   // bytes of shared memory an H100 block may have

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// VEC consecutive elements of T: one 16-byte access (VEC = 16 / sizeof(T))
// or one element (VEC = 1).
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    uint4 q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// Copy one access from device to shared memory: cp.async for 16 bytes.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (VEC == 1) {
    *dst = *src;
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  }
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// How a launch cuts the work (norm_plan in ops/norm.py): k groups a
// block, p blocks a cluster, `rows` rows a block.
struct Cut {
  int C, G, V, n_valid, k, p, rows;
};

// The shared memory of a block: the staged slice (`arrays` arrays of
// rows x W elements, each rounded up to 16 bytes),
// then f32 scratch: two trees of threads x VEC partials, two exchange
// arrays of W per-channel sums (read by the cluster), and two k-arrays of
// per-group values.
__host__ __device__ __forceinline__ int64_t slice_bytes(int rows, int W, int esize) {
  return ((int64_t)rows * W * esize + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int64_t scratch_bytes(int threads, int vec, int W, int k) {
  return 4 * ((int64_t)2 * threads * vec + 2 * W + 2 * k);
}

// Sum each thread's VEC partials over the threads that own the same
// channels (t = v + j nv, j = 0 .. threads/nv - 1) by a fixed tree; the
// W per-channel sums end in red[0 .. W). Both trees at once where TWO (else
// red1 and a1 are unused).
template <int VEC, bool TWO>
__device__ __forceinline__ void tree(float* red0, float* red1, const float (&a0)[VEC],
                                     const float (&a1)[VEC], int W, int nv) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red0[t * VEC + e] = a0[e];
    if constexpr (TWO) red1[t * VEC + e] = a1[e];
  }
  __syncthreads();
  for (int n = blockDim.x / nv; n > 1;) {
    const int h = (n + 1) / 2;
    for (int i = t; i < (n - h) * W; i += blockDim.x) {
      red0[i] += red0[i + h * W];
      if constexpr (TWO) red1[i] += red1[i + h * W];
    }
    __syncthreads();
    n = h;
  }
}

// The cluster's per-channel totals: `mine` (W sums, this block's) is read by
// every block of the cluster; each sums the p blocks' in rank order into
// `out`. The caller synchronises the block before `out` is read.
__device__ __forceinline__ void exchange(cgr::cluster_group& cluster, float* mine,
                                         float* out, int W, int p) {
  cluster.sync();
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < p; ++q) s += cluster.map_shared_rank(mine, q)[c];
    out[c] = s;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_relu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                           Cut u, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int cg = u.C / u.G, W = u.k * cg, nv = W / VEC;
  const int rank = (int)cluster.block_rank(), chunk = blockIdx.x / u.p, b = blockIdx.y;
  const int r0 = rank * u.rows, r1 = min(u.V, r0 + u.rows), rv = min(r1, u.n_valid);
  const int t = threadIdx.x, v = t % nv, step = blockDim.x / nv;
  const int64_t at = (int64_t)b * u.V * u.C + (int64_t)chunk * W + v * VEC;

  T* xs = reinterpret_cast<T*>(smem);
  float* red0 = reinterpret_cast<float*>(smem + slice_bytes(u.rows, W, sizeof(T)));
  float* red1 = red0 + blockDim.x * VEC;
  float* chan = red1 + blockDim.x * VEC;   // [2][W]: the two exchanges
  float* stat = chan + 2 * W;              // [2][k]: mean, rstd

  // this thread's accesses, rows r0 + t / nv every `step` rows, copied into
  // the part's slice in shared memory (W elements a row)
  for (int r = r0 + t / nv; r < r1; r += step)
    stage<T, VEC>(xs + (int64_t)(r - r0) * W + v * VEC, x + at + (int64_t)r * u.C);
  staged();
  auto src = [&](int r) { return xs + (int64_t)(r - r0) * W + v * VEC; };
  const float n = (float)u.n_valid * cg;

  // pass 1: the mean
  float a[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = 0.f;
  for (int r = r0 + t / nv; r < rv; r += step) {
    float xv[VEC];
    load<T, VEC>(src(r), xv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] += xv[e];
  }
  tree<VEC, false>(red0, nullptr, a, a, W, nv);
  for (int c = t; c < W; c += blockDim.x) chan[c] = red0[c];
  exchange(cluster, chan, red1, W, u.p);
  __syncthreads();
  for (int j = t; j < u.k; j += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < cg; ++i) s += red1[j * cg + i];
    stat[j] = s / n;
  }
  __syncthreads();

  float mu[VEC], gm[VEC], bt[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = v * VEC + e, ch = chunk * W + c;
    mu[e] = stat[c / cg];
    gm[e] = to_f32(from_f32<T>(gamma[ch]));
    bt[e] = to_f32(from_f32<T>(beta[ch]));
  }

  // pass 2: the variance about that mean
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = 0.f;
  for (int r = r0 + t / nv; r < rv; r += step) {
    float xv[VEC];
    load<T, VEC>(src(r), xv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = __fsub_rn(xv[e], mu[e]);
      a[e] += __fmul_rn(d, d);
    }
  }
  tree<VEC, false>(red0, nullptr, a, a, W, nv);
  for (int c = t; c < W; c += blockDim.x) chan[W + c] = red0[c];
  exchange(cluster, chan + W, red1, W, u.p);
  __syncthreads();
  for (int j = t; j < u.k; j += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < cg; ++i) s += red1[j * cg + i];
    const float rstd = 1.f / sqrtf(s / n + eps);
    stat[u.k + j] = rstd;
    if (rank == 0) {
      const int64_t o = (int64_t)b * u.G + (int64_t)chunk * u.k + j;
      mean_out[o] = stat[j];
      rstd_out[o] = rstd;
    }
  }
  __syncthreads();

  // pass 3: y over every row of the part
  float rs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) rs[e] = stat[u.k + (v * VEC + e) / cg];
  for (int r = r0 + t / nv; r < r1; r += step) {
    float xv[VEC];
    load<T, VEC>(src(r), xv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv[e], mu[e]), rs[e]), gm[e]), bt[e]);
      xv[e] = z < 0.f ? 0.f : z;   // torch.relu: NaN stays NaN
    }
    store<T, VEC>(y + at + (int64_t)r * u.C, xv);
  }
  cluster.sync();   // no block leaves while another may read its exchange
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_relu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           T* __restrict__ dx, float* __restrict__ part, Cut u) {
  extern __shared__ __align__(16) unsigned char smem[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int cg = u.C / u.G, W = u.k * cg, nv = W / VEC;
  const int rank = (int)cluster.block_rank(), chunk = blockIdx.x / u.p, b = blockIdx.y;
  const int r0 = rank * u.rows, r1 = min(u.V, r0 + u.rows), rv = min(r1, u.n_valid);
  const int t = threadIdx.x, v = t % nv, step = blockDim.x / nv;
  const int64_t at = (int64_t)b * u.V * u.C + (int64_t)chunk * W + v * VEC;

  const int64_t sb = slice_bytes(u.rows, W, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + sb);
  float* red0 = reinterpret_cast<float*>(smem + 2 * sb);
  float* red1 = red0 + blockDim.x * VEC;
  float* chan = red1 + blockDim.x * VEC;   // [2][W]: dgamma, dbeta terms of this block
  float* stat = chan + 2 * W;              // [2][k]: sum(dx^) / n, sum(dx^ x^) / n

  for (int r = r0 + t / nv; r < r1; r += step) {
    const int64_t o = (int64_t)(r - r0) * W + v * VEC, g = at + (int64_t)r * u.C;
    stage<T, VEC>(xs + o, x + g);
    stage<T, VEC>(gs + o, dy + g);
  }
  staged();
  float mu[VEC], rs[VEC], gm[VEC], bt[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = v * VEC + e, ch = chunk * W + c;
    const int64_t o = (int64_t)b * u.G + (int64_t)chunk * u.k + c / cg;
    mu[e] = mean[o];
    rs[e] = rstd[o];
    gm[e] = to_f32(from_f32<T>(gamma[ch]));
    bt[e] = to_f32(from_f32<T>(beta[ch]));
  }
  // x^, and dz = the ReLU's mask (z > 0, z as the forward computed it) times dy
  auto grads = [&](int r, float (&xh)[VEC], float (&dz)[VEC]) {
    float xv[VEC], gv[VEC];
    const int64_t o = (int64_t)(r - r0) * W + v * VEC;
    load<T, VEC>(xs + o, xv);
    load<T, VEC>(gs + o, gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      xh[e] = __fmul_rn(__fsub_rn(xv[e], mu[e]), rs[e]);
      const float z = __fadd_rn(__fmul_rn(xh[e], gm[e]), bt[e]);
      dz[e] = z <= 0.f ? 0.f : gv[e];   // relu's backward: zero where y <= 0
    }
  };

  // pass 1: per-channel sums of dz and dz x^ over the valid rows
  float ab[VEC], ag[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) ab[e] = ag[e] = 0.f;
  for (int r = r0 + t / nv; r < rv; r += step) {
    float xh[VEC], dz[VEC];
    grads(r, xh, dz);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ab[e] += dz[e];
      ag[e] += __fmul_rn(dz[e], xh[e]);
    }
  }
  tree<VEC, true>(red0, red1, ag, ab, W, nv);
  for (int c = t; c < W; c += blockDim.x) {
    chan[c] = red0[c];
    chan[W + c] = red1[c];
  }
  // the cluster's totals of both: dgamma's into red0, dbeta's into red1
  cluster.sync();
  for (int c = t; c < W; c += blockDim.x) {
    float sg = 0.f, sbt = 0.f;
    for (int q = 0; q < u.p; ++q) {
      const float* other = cluster.map_shared_rank(chan, q);
      sg += other[c];
      sbt += other[W + c];
    }
    red0[c] = sg;
    red1[c] = sbt;
    if (rank == 0) {
      const int64_t o = (int64_t)b * 2 * u.C + (int64_t)chunk * W + c;
      part[o] = sg;
      part[o + u.C] = sbt;
    }
  }
  __syncthreads();
  const float n = (float)u.n_valid * cg;
  for (int j = t; j < u.k; j += blockDim.x) {
    float sa = 0.f, sx = 0.f;
    for (int i = 0; i < cg; ++i) {
      const int c = j * cg + i;
      const float g = to_f32(from_f32<T>(gamma[(int64_t)chunk * W + c]));
      sa += __fmul_rn(g, red1[c]);
      sx += __fmul_rn(g, red0[c]);
    }
    stat[j] = sa / n;
    stat[u.k + j] = sx / n;
  }
  __syncthreads();

  // pass 2: dx over every row of the part
  float ma[VEC], mx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    ma[e] = stat[(v * VEC + e) / cg];
    mx[e] = stat[u.k + (v * VEC + e) / cg];
  }
  for (int r = r0 + t / nv; r < r1; r += step) {
    float xh[VEC], dz[VEC], out[VEC];
    grads(r, xh, dz);
    const bool valid = r < u.n_valid;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float dxh = __fmul_rn(dz[e], gm[e]);
      out[e] = valid ? __fmul_rn(rs[e], __fsub_rn(__fsub_rn(dxh, ma[e]), __fmul_rn(xh[e], mx[e])))
                     : __fmul_rn(rs[e], dxh);
    }
    store<T, VEC>(dx + at + (int64_t)r * u.C, out);
  }
  cluster.sync();   // no block leaves while another may read its exchange
}

// dgamma[c] = sum_b part[b][0][c], dbeta[c] = sum_b part[b][1][c], b in order.
__global__ void group_norm_relu_dparam_kernel(const float* __restrict__ part,
                                              float* __restrict__ dgamma,
                                              float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sbt = 0.f;
  for (int b = 0; b < B; ++b) {
    sg += part[(int64_t)b * 2 * C + c];
    sbt += part[(int64_t)b * 2 * C + C + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sbt;
}

// Launch `kernel` over the cut's grid, p blocks a cluster.
template <typename... Exp, typename... Act>
int launch(void (*kernel)(Exp...), const Cut& u, int B, int threads, int smem,
           cudaStream_t s, Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(u.p * (u.G / u.k), B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = u.p;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The plan's checks: what the kernels rely on, so that a wrong plan is
// refused and never reads or writes out of bounds.
bool valid_cut(const Cut& u, int B, int vec, int threads, int smem, int esize, int arrays,
               const void* const* ptrs, int nptrs) {
  if (B <= 0 || B > 65535 || u.V <= 0 || u.C <= 0 || u.G <= 0 || u.C % u.G || u.k <= 0 ||
      u.G % u.k || u.n_valid <= 0 || u.n_valid > u.V || u.p < 1 || u.p > MAX_CLUSTER ||
      u.rows <= 0 || (int64_t)u.rows * u.p < u.V)
    return false;
  const int W = u.k * (u.C / u.G);
  if (W % vec || threads <= 0 || threads > MAX_THREADS || threads % (W / vec)) return false;
  if (vec > 1) {
    if (u.C % vec) return false;
    for (int i = 0; i < nptrs; ++i)
      if ((uintptr_t)ptrs[i] % 16) return false;
  }
  const int64_t need = arrays * slice_bytes(u.rows, W, esize) +
                       scratch_bytes(threads, vec, W, u.k);
  return smem == need && need <= SMEM_MAX;
}

template <typename T>
int forward(const void* x, const float* gamma, const float* beta, void* y, float* mean,
            float* rstd, const Cut& u, int B, int vec, int threads, int smem, float eps,
            cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec == 1)
    return launch(group_norm_relu_fwd_kernel<T, 1>, u, B, threads, smem, s, xt, gamma, beta, yt,
                  mean, rstd, u, eps);
  return launch(group_norm_relu_fwd_kernel<T, 16 / sizeof(T)>, u, B, threads, smem, s, xt, gamma,
                beta, yt, mean, rstd, u, eps);
}

template <typename T>
int backward(const void* x, const void* dy, const float* gamma, const float* beta,
             const float* mean, const float* rstd, void* dx, float* part, const Cut& u, int B,
             int vec, int threads, int smem, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dt = static_cast<T*>(dx);
  if (vec == 1)
    return launch(group_norm_relu_bwd_kernel<T, 1>, u, B, threads, smem, s, xt, gt, gamma, beta,
                  mean, rstd, dt, part, u);
  return launch(group_norm_relu_bwd_kernel<T, 16 / sizeof(T)>, u, B, threads, smem, s, xt, gt,
                gamma, beta, mean, rstd, dt, part, u);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x and y [B, V, C] contiguous,
// in that dtype; gamma, beta [C] and mean, rstd [B, G] float32; all on the
// device of `stream`. The plan (vec, k, p, rows, threads, smem)
// is norm_plan's (ops/norm.py), checked here. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int cape_group_norm_relu_fwd(const void* x, const void* gamma, const void* beta,
                                        void* y, void* mean, void* rstd, int dtype, int B,
                                        int V, int C, int G, int n_valid, int vec, int k, int p,
                                        int rows, int threads, int smem, float eps,
                                        void* stream) {
  const Cut u{C, G, V, n_valid, k, p, rows};
  const int esize = dtype == 0 ? 4 : 2;
  const void* ptrs[] = {x, y};
  if (dtype < 0 || dtype > 2 || (vec != 1 && vec != 16 / esize) ||
      !valid_cut(u, B, vec, threads, smem, esize, 1, ptrs, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return forward<float>(x, g, bt, y, m, r, u, B, vec, threads, smem, eps, s);
  if (dtype == 1) return forward<__nv_bfloat16>(x, g, bt, y, m, r, u, B, vec, threads, smem, eps, s);
  return forward<__half>(x, g, bt, y, m, r, u, B, vec, threads, smem, eps, s);
}

// dy and dx as x; `part` [B, 2, C] float32 scratch; dgamma, dbeta [C] float32.
// Two launches: the kernel that writes dx and each sample's dgamma and dbeta
// terms, then their sum over the batch.
extern "C" int cape_group_norm_relu_bwd(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* mean, const void* rstd,
                                        void* dx, void* part, void* dgamma, void* dbeta,
                                        int dtype, int B, int V, int C, int G, int n_valid,
                                        int vec, int k, int p, int rows, int threads,
                                        int smem, void* stream) {
  const Cut u{C, G, V, n_valid, k, p, rows};
  const int esize = dtype == 0 ? 4 : 2;
  const void* ptrs[] = {x, dy, dx};
  if (dtype < 0 || dtype > 2 || (vec != 1 && vec != 16 / esize) ||
      !valid_cut(u, B, vec, threads, smem, esize, 2, ptrs, 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  int err;
  if (dtype == 0)
    err = backward<float>(x, dy, g, bt, m, r, dx, pt, u, B, vec, threads, smem, s);
  else if (dtype == 1)
    err = backward<__nv_bfloat16>(x, dy, g, bt, m, r, dx, pt, u, B, vec, threads, smem, s);
  else
    err = backward<__half>(x, dy, g, bt, m, r, dx, pt, u, B, vec, threads, smem, s);
  if (err != 0) return err;
  group_norm_relu_dparam_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      pt, static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, C);
  return (int)cudaGetLastError();
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
