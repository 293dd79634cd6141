// Fused K=2 Chebyshev graph convolution over a ring of x tiles, for Hopper
// (sm_90a), batch-major. The same function as cheb2_fused.cu:
//
//   lx[b, r, c] = round_T( sum_k sum_j blocks[k, t, i, j] * x[b, (t+k)*128 + j - pad_left, c] )
//   y[b, r, f]  = round_T( sum_c x[b, r - pad_left % 128, c] * w0[c, f]
//                          + sum_c lx[b, r, c] * w1[c, f] )
//
// for output rows r = t*128 + i < rows_out; rows of x outside [0, rows_in)
// read as zero (masked, never read out of bounds). round_T rounds an f32
// value to the dtype T of x (f32 or bf16); both sums are f32 and are added
// before the one rounding of y.
//
// Replaces two TPU kernels of cape_tpu/ops/pallas/cheb_kernel.py:
// `_pallas_cheb2_v6_impl` (kernel 5, body `_make_kernel_v6`) and
// `_pallas_cheb2_v7_impl` (kernel 6, body `_make_kernel_v7`). Their grid
// walks the padded x tiles in order, one (v6) or two (v7, R = 2) per step,
// and keeps the tiles that the window of S band shifts still needs in a VMEM
// ring of shape (S, B, 128, C): each padded x tile leaves HBM once, and L~x
// never exists there. On the GPU blocks run in parallel and in no order, so
// no single ring can walk the whole sequence. Here a cluster of NB blocks
// owns one sample and a run of `run` consecutive output row tiles and walks
// them in order, R tiles per step: a loop takes the place of the sequential
// grid. Within a run each x tile leaves device memory once, plus S - 1 halo
// tiles at the start of the run; the host picks the run length so that the
// clusters of all samples fill the card (cape_cheb2_ring_plan).
//
// The ring does not fit one block's shared memory at most widths: S tiles of
// 128 rows by C channels are 160 KB at S = 5, C = 64 in f32. The band sum is
// independent per channel, so the blocks of a cluster split the channels:
// block `rank` holds channels [rank*CB, rank*CB + CB) of every ring tile,
// S + 2R - 1 slots (the window's S + R - 1 tiles and the R tiles of the next
// step, copied with cp.async while this step computes). It sums its slice of
// L~x in f32 and rounds it to T. After a cluster barrier each block projects
// its share of the F output columns, reading all C channels of the centre x
// tile and of L~x from its peers' shared memory (distributed shared memory,
// cluster.map_shared_rank). The host picks the smallest cluster (1 to 16
// blocks; 16 only where the card can schedule it) whose blocks fit; a shape
// that no cluster holds is refused.
//
// Schedule of a block (8*CB threads; every thread keeps a 4 x 4 tile of sums
// in registers, 4 consecutive rows by 4 consecutive channels or columns):
//   1. band sum: for each of the step's R output tiles and each shift k, the
//      block stages the 128 x 128 band block in pieces of 32 columns, skips a
//      piece that is all zero (one __syncthreads_or), and adds its product
//      with the ring tile into the registers; lx is rounded to T and stored
//      transposed ([channel][row], f32). Then a cluster barrier.
//   2. projections: for each output tile, its share of F in chunks of CB
//      columns; over the C channels (peer by peer, at most 32 at a time) it
//      stages the centre tile's rows (the padded tile t + pad_left / 128) and
//      L~x from the owning peer, and the matching rows of w0 and w1, with two
//      register sums (x w0 and lx w1) as in the TPU kernels. y is written
//      once. A cluster barrier ends the step: no peer still reads a slot or
//      lx when the next step's copies and sums overwrite them.
//
// What bounds it: the band blocks are dense 128 x 128 tiles of a mesh
// Laplacian that is about 1% non-zero, so dense arithmetic on them is ~100x
// the necessary work; the zero-piece skip drops the pieces off the band. The
// projections, 4 * C * F FLOP per output row and sample, run on the CUDA
// cores (no tensor cores in this version). Every block of a cluster stages
// the same band pieces, for every sample: the band is read from L2 B * NB
// times. The ring saves the S-fold x window reads of cheb2_fused.cu's row
// slabs and keeps L~x out of device memory; it does not touch the arithmetic.
// On an NVIDIA H100 80GB HBM3 (700 W) it is latency-bound: at [32, 6912, 64]
// in f32 a cluster's blocks take 157 KB each, one block of 8 warps per SM,
// and every step waits on its band-piece loads and its ~40 barriers (a warp
// vote that serialized the piece loads cost 20-40% more time). It took 1.68
// ms there, cheb2_fused.cu at one sample per block 1.01.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RB = 128;           // rows per band block, and its column width
constexpr int KB = 32;            // band columns per staged band piece
constexpr int LD = RB + 4;        // row stride (floats) of the [channel][row] arrays
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may have
constexpr int MAX_CLUSTER = 16;   // H100: 8 portable, 16 with the non-portable attribute

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// four consecutive values, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// 16 bytes from device to shared memory without a register round trip;
// `in` false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest has landed (in this thread's view)
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
// channels per projection staging step
__host__ __device__ constexpr int stage_channels(int cb) { return cb < 32 ? cb : 32; }
// floats of the work area: the band piece [KB][LD], or the projection's
// staged x_c and lx chunks [KC][LD] and w0, w1 chunks [KC][CB]
__host__ __device__ constexpr int work_floats(int cb) {
  return cmax(KB * LD, 2 * stage_channels(cb) * (LD + cb));
}
// shared memory of a block: the ring [S + 2R - 1][128][CB] in T, lx
// [R][CB][LD] and the work area in f32
int smem_bytes(int cb, int S, int R, int elem) {
  return (S + 2 * R - 1) * RB * cb * elem + 4 * (R * cb * LD + work_floats(cb));
}

struct RingArgs {
  const void* x;
  const void* blocks;
  const void* w0;
  const void* w1;
  void* y;
  int rows_in, C, F, S, n_tiles, pad_left, rows_out;
  int run;   // output tiles per cluster, a multiple of R
  int vec;   // 1: every block's channel slice is 16-byte aligned and inside C (cp.async)
};

template <typename T, int CB, int R>
__global__ void __launch_bounds__(8 * CB) cheb2_ring_kernel(const RingArgs a) {
  constexpr int NT = 8 * CB;                 // threads
  constexpr int TX = CB / 4;                 // threads along channels / columns; 32 along rows
  constexpr int KC = stage_channels(CB);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ blocks = static_cast<const T*>(a.blocks);
  const T* __restrict__ w0 = static_cast<const T*>(a.w0);
  const T* __restrict__ w1 = static_cast<const T*>(a.w1);
  T* __restrict__ y = static_cast<T*>(a.y);

  cg::cluster_group cluster = cg::this_cluster();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;                            // the cluster's sample
  const int t0 = (blockIdx.x / nb) * a.run;            // its first output tile
  const int steps = (min(a.run, a.n_tiles - t0) + R - 1) / R;
  const int nslot = a.S + 2 * R - 1;
  const int c_lo = rank * CB;                          // the block's first channel
  const int kc = a.pad_left / RB;                      // centre tile's offset in the window

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);               // [nslot][RB][CB]: ring[s][j][c]
  float* lx = reinterpret_cast<float*>(ring + static_cast<size_t>(nslot) * RB * CB);  // [R][CB][LD]
  float* work = lx + R * CB * LD;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;              // channels/columns 4tx.., rows 4ty..
  const T* xb = x + static_cast<int64_t>(b) * a.rows_in * a.C;

  // the block's channels of padded tile q of the run (x rows (t0+q)*128 - pad_left ..)
  auto load_tile = [&](int q) {
    T* dst = ring + static_cast<size_t>(q % nslot) * RB * CB;
    const int row0 = (t0 + q) * RB - a.pad_left;
    if (a.vec) {
      constexpr int EL = 16 / sizeof(T);               // elements per 16-byte copy
      constexpr int PER_ROW = CB / EL;
      for (int l = tid; l < RB * PER_ROW; l += NT) {
        const int j = l / PER_ROW, e = (l % PER_ROW) * EL;
        const int r = row0 + j;
        const bool in = r >= 0 && r < a.rows_in;
        cp_async16(dst + j * CB + e, in ? xb + static_cast<int64_t>(r) * a.C + c_lo + e : xb, in);
      }
    } else {
      for (int l = tid; l < RB * CB; l += NT) {
        const int j = l / CB, c = c_lo + l % CB;
        const int r = row0 + j;
        dst[l] = (r >= 0 && r < a.rows_in && c < a.C) ? xb[static_cast<int64_t>(r) * a.C + c]
                                                      : from_f32<T>(0.f);
      }
    }
  };

  // the first step's window: padded tiles 0 .. S + R - 2 of the run
  for (int q = 0; q < a.S + R - 1; ++q) load_tile(q);
  cp_async_commit();

  const int FB = (a.F + nb - 1) / nb;                  // the block's share of the columns
  const int f_lo = rank * FB, f_hi = min(a.F, f_lo + FB);
  float* xs_s = work;                                  // [KC][LD]: centre x rows, transposed
  float* lx_s = xs_s + KC * LD;                        // [KC][LD]: lx rows
  float* w0_s = lx_s + KC * LD;                        // [KC][CB]
  float* w1_s = w0_s + KC * CB;                        // [KC][CB]

  for (int n = 0; n < steps; ++n) {
    // the next step's R new tiles go to the slots of this step's predecessor's
    // first R tiles, which no thread of the cluster reads any more
    if (n + 1 < steps)
      for (int q = (n + 1) * R + a.S - 1; q < (n + 2) * R + a.S - 1; ++q) load_tile(q);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    // ---- 1. the band sum of each output tile, this block's channels
    for (int r = 0; r < R; ++r) {
      const int t = t0 + n * R + r;
      if (t >= a.n_tiles) break;                       // v7's last step of an odd T
      float acc[4][4] = {};
      for (int k = 0; k < a.S; ++k) {
        const T* xs = ring + static_cast<size_t>((n * R + r + k) % nslot) * RB * CB;
        const T* blk = blocks + (static_cast<int64_t>(k) * a.n_tiles + t) * RB * RB;
        for (int j0 = 0; j0 < RB; j0 += KB) {
          bool nz = false;
          for (int l = tid; l < RB * KB; l += NT) {
            const int i = l / KB, jj = l % KB;
            const float v = to_f32(blk[i * RB + j0 + jj]);
            work[jj * LD + i] = v;
            nz |= (v != 0.f);
          }
          // barrier for the piece; a piece with no band entry adds nothing
          if (!__syncthreads_or(nz)) continue;
#pragma unroll 8
          for (int jj = 0; jj < KB; ++jj)
            fma4x4(acc, load4(work + jj * LD + 4 * ty), load4(xs + (j0 + jj) * CB + 4 * tx));
          __syncthreads();
        }
      }
      // round to x's dtype: the W1 product takes lx in T, as in the TPU kernels
      float* lxr = lx + r * CB * LD;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(lxr + (4 * tx + c) * LD + 4 * ty) =
            make_float4(round_to<T>(acc[0][c]), round_to<T>(acc[1][c]), round_to<T>(acc[2][c]),
                        round_to<T>(acc[3][c]));
    }
    cluster.sync();   // every block's lx and ring tiles are complete and visible

    // ---- 2. y = x_c w0 + lx w1 for this block's columns, all C channels
    for (int r = 0; r < R; ++r) {
      const int t = t0 + n * R + r;
      if (t >= a.n_tiles) break;
      const int slot_c = (n * R + r + kc) % nslot;     // padded tile t + pad_left / 128
      for (int f0 = f_lo; f0 < f_hi; f0 += CB) {
        float acc0[4][4] = {}, acc1[4][4] = {};
        for (int p = 0; p < nb; ++p) {
          const T* pr = cluster.map_shared_rank(ring, p) + static_cast<size_t>(slot_c) * RB * CB;
          const float* pl = cluster.map_shared_rank(lx, p) + r * CB * LD;
          for (int cc0 = 0; cc0 < CB; cc0 += KC) {
            const int c0 = p * CB + cc0;
            const int kw = min(KC, a.C - c0);
            if (kw <= 0) break;
            for (int l = tid; l < RB * KC; l += NT) {
              const int i = l / KC, jj = l % KC;
              xs_s[jj * LD + i] = to_f32(pr[i * CB + cc0 + jj]);
            }
            for (int l = tid; l < KC * (RB / 4); l += NT) {
              const int jj = l / (RB / 4), i = 4 * (l % (RB / 4));
              *reinterpret_cast<float4*>(lx_s + jj * LD + i) =
                  *reinterpret_cast<const float4*>(pl + (cc0 + jj) * LD + i);
            }
            for (int l = tid; l < KC * CB; l += NT) {
              const int jj = l / CB, f = f0 + l % CB;
              const bool in = jj < kw && f < f_hi;
              const int64_t at = static_cast<int64_t>(c0 + jj) * a.F + f;
              w0_s[l] = in ? to_f32(w0[at]) : 0.f;
              w1_s[l] = in ? to_f32(w1[at]) : 0.f;
            }
            __syncthreads();
            for (int jj = 0; jj < kw; ++jj) {
              fma4x4(acc0, load4(xs_s + jj * LD + 4 * ty), load4(w0_s + jj * CB + 4 * tx));
              fma4x4(acc1, load4(lx_s + jj * LD + 4 * ty), load4(w1_s + jj * CB + 4 * tx));
            }
            __syncthreads();
          }
        }
        // one write of y
        T* yb = y + static_cast<int64_t>(b) * a.rows_out * a.F;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = t * RB + 4 * ty + i;
          if (row >= a.rows_out) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int f = f0 + 4 * tx + c;
            if (f < f_hi) yb[static_cast<int64_t>(row) * a.F + f] = from_f32<T>(acc0[i][c] + acc1[i][c]);
          }
        }
      }
    }
    cluster.sync();   // no peer reads this block's ring or lx any more
  }
}

using RingKernel = void (*)(RingArgs);

template <typename T, int R>
RingKernel kernel_for(int cb) {
  if (cb == 8) return cheb2_ring_kernel<T, 8, R>;
  if (cb == 16) return cheb2_ring_kernel<T, 16, R>;
  if (cb == 32) return cheb2_ring_kernel<T, 32, R>;
  return nullptr;
}

struct Plan {
  int nb, cb, run, smem;   // cluster size, channels per block, output tiles per run, bytes
};

cudaLaunchConfig_t launch_config(const Plan& p, dim3 grid, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.nb;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(8 * p.cb);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The smallest cluster whose blocks hold their ring slice, lx and work area
// in shared memory and that the card can schedule; the run length that lets
// the clusters of all B samples fill the card at once. p->nb == 0: no
// cluster of at most MAX_CLUSTER blocks fits (the shape is refused).
template <typename T, int R>
cudaError_t make_plan(int B, int C, int S, int n_tiles, Plan* p) {
  *p = Plan{0, 0, 0, 0};
  for (int nb = 1; nb <= MAX_CLUSTER; nb *= 2) {
    const int per = (C + nb - 1) / nb;
    const int cb = per <= 8 ? 8 : per <= 16 ? 16 : per <= 32 ? 32 : 0;
    if (cb == 0) continue;
    const Plan cand{nb, cb, 0, smem_bytes(cb, S, R, sizeof(T))};
    if (cand.smem > SMEM_MAX) continue;
    RingKernel kernel = kernel_for<T, R>(cb);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cand.smem);
    if (err == cudaSuccess && nb > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(cand, dim3(nb), nullptr, &attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
      (void)cudaGetLastError();   // not schedulable at this size; clear the error
      clusters = 0;
    }
    if (clusters == 0) continue;
    const int runs = cmax(1, cmin(n_tiles, clusters / B));
    const int run = (n_tiles + runs - 1) / runs;
    *p = cand;
    p->run = (run + R - 1) / R * R;
    return cudaSuccess;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_for(int R, int B, int C, int S, int n_tiles, Plan* p) {
  return R == 1 ? make_plan<T, 1>(B, C, S, n_tiles, p) : make_plan<T, 2>(B, C, S, n_tiles, p);
}

template <typename T, int R>
int launch(RingArgs a, int B, cudaStream_t s) {
  Plan p;
  cudaError_t err = make_plan<T, R>(B, a.C, a.S, a.n_tiles, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.nb == 0) return (int)cudaErrorInvalidValue;
  a.run = p.run;
  a.vec = p.nb * p.cb == a.C && (a.C * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int runs = (a.n_tiles + p.run - 1) / p.run;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, dim3(p.nb * runs, B), s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel_for<T, R>(p.cb), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool valid(int dtype, int B, int C, int S, int n_tiles, int R) {
  return (dtype == 0 || dtype == 1) && B > 0 && B <= 65535 && C > 0 && S > 0 && n_tiles > 0 &&
         (R == 1 || R == 2);
}

}  // namespace

// The launch plan of cape_cheb2_ring for these sizes, in plan[0..3]: the
// cluster size (0: no cluster holds the ring; the launch would be refused),
// the channels per block, the output tiles per run and the shared memory of
// a block in bytes. Returns a cudaError_t.
extern "C" int cape_cheb2_ring_plan(int dtype, int B, int C, int S, int n_tiles, int R, int* plan) {
  if (!valid(dtype, B, C, S, n_tiles, R)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = dtype == 0 ? plan_for<float>(R, B, C, S, n_tiles, &p)
                                     : plan_for<__nv_bfloat16>(R, B, C, S, n_tiles, &p);
  plan[0] = p.nb;
  plan[1] = p.cb;
  plan[2] = p.run;
  plan[3] = p.smem;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], blocks [S, n_tiles,
// 128, 128], w0 and w1 [C, F] and y [B, rows_out, F] are contiguous, in that
// dtype, on the device of `stream`; pad_left < S * 128 (the centre tile lies
// in the window); R = 1 (v6) or 2 (v7) output tiles per step. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int cape_cheb2_ring(const void* x, const void* blocks, const void* w0, const void* w1,
                               void* y, int dtype, int B, int rows_in, int C, int F, int S,
                               int n_tiles, int pad_left, int rows_out, int R, void* stream) {
  if (!valid(dtype, B, C, S, n_tiles, R) || F <= 0 || rows_in < 0 || pad_left < 0 ||
      pad_left >= S * RB || rows_out <= 0 || rows_out > n_tiles * RB)
    return (int)cudaErrorInvalidValue;
  const RingArgs a{x, blocks, w0, w1, y, rows_in, C, F, S, n_tiles, pad_left, rows_out, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return R == 1 ? launch<float, 1>(a, B, s) : launch<float, 2>(a, B, s);
  return R == 1 ? launch<__nv_bfloat16, 1>(a, B, s) : launch<__nv_bfloat16, 2>(a, B, s);
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
