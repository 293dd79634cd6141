// Fused K=2 Chebyshev graph convolution for Hopper (sm_90a), batch-major.
//
//   lx[b, r, c] = round_T( sum_k sum_j blocks[k, t, i, j] * x[b, (t+k)*128 + j - pad_left, c] )
//   y[b, r, f]  = round_T( sum_c x[b, r - pad_left % 128, c] * w0[c, f]
//                          + sum_c lx[b, r, c] * w1[c, f] )
//
// for output rows r = t*128 + i < rows_out; rows of x outside [0, rows_in)
// read as zero (masked here, never read out of bounds). round_T rounds an
// f32 value to the dtype T of x (f32 or bf16); both sums are f32 and are
// added before the one rounding of y.
//
// Replaces two TPU kernels of cape_tpu/ops/pallas/cheb_kernel.py that
// compute the same conv with the intermediate L~x kept out of device memory:
// `_pallas_cheb2_impl` (kernel 1, body `_make_kernel`: one sample per grid
// row, L~x in a VMEM scratch accumulated over a sequential shift axis) and
// `_pallas_cheb2_v5_impl` (kernel 4, body `_make_kernel_v5`: G samples
// merged into the 128 lanes, with both projections against a
// block-diagonal kron(I_G, W)). Here a block owns a group of G samples
// (G = 1 for kernel 1, v5's group for kernel 4), a slab of RS rows of one
// 128-row tile and all F output columns. The block-diagonal weight is not
// built: it is a trick to fill the TPU's lanes and would cost G times the
// projection FLOPs for the same result. On the GPU, merging samples means
// that the band pieces a block stages and the x window it walks serve G
// samples at once.
//
// Schedule (256 threads; every thread keeps a 4 x 4 tile of sums in
// registers, 4 consecutive rows by 4 consecutive columns, read from shared
// memory as float4):
//   1. band sum: lx, the RS x (G*C) f32 sum for the block's RS rows, lives
//      in shared memory (transposed, [G*C][RS], so a thread's 4 rows are
//      one float4). The block steps over the S shifts in pieces of KC = 32
//      band columns; it stages each RS x KC band piece once, skips it if it
//      is all zero (one __syncthreads_or), and otherwise walks the G*C
//      merged columns NT = 4096 / RS at a time, staging the KC x NT x window
//      and adding the piece's product into lx. So one staged band piece
//      serves all G samples. lx is then rounded to T in place: the W1
//      product takes lx in T, as in the TPU kernels.
//   2. projections: the G samples' RS rows are one M = G*RS row dimension,
//      MR rows and 4096 / MR output columns at a time; the block steps over
//      C in chunks of KC, staging x's centre rows (the padded row block
//      t + pad_left / 128) and the matching chunks of w0 and w1, with two
//      register sums (x w0 and lx w1) as in the TPU kernels. A staged weight
//      chunk thus serves the G samples too.
//   3. y is written once.
// RS is 64, 32 or 16: the largest whose lx fits beside the staging buffers
// in half an SM's shared memory (two blocks per SM), else 16 if it fits the
// 227 KB a block may have (dynamic shared memory, raised with
// cudaFuncSetAttribute above 48 KB): G*C <= 1977 (2284 with G >= 4). A
// smaller RS is taken while the grid would leave fewer than two blocks per
// SM. The projection tile is MR = 64, 32 or 16 rows (at most G*RS) by
// 4096 / MR columns, so that every thread has work when the group holds
// fewer than 64 rows. At the encoder's C = 512 with G = 4, lx takes 160 KB
// (RS = 16).
//
// What bounds it: the band blocks are dense 128 x 128 tiles of a mesh
// Laplacian that is about 1% non-zero, so dense arithmetic on them is ~100x
// the necessary work; the zero-piece skip drops most pieces of a row slab,
// which lie off the band's diagonal. What remains is the projections,
// 4 * C * F FLOP per output row and sample, on the CUDA cores (no tensor
// cores in this version), and the x window, which each of the 128 / RS row
// slabs of a tile reads again from L2. The gain over the unfused route is
// that L~x, [B, P, C], is never written to or read from device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RB = 128;          // rows per band block, and its column width
constexpr int KC = 32;           // band columns / channels per shared-memory step
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may have

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int PAD = 4;           // keeps float4 rows 16-byte aligned, spreads banks
constexpr int TILE = 4096;       // sums per 256-thread register tile (16 each)

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// shared-memory floats of a block besides lx, for RS slab rows and MR
// projection rows: the band piece or x_c, the x window or the w0 chunk, and
// the w1 chunk
constexpr int fixed_floats(int RS, int MR) {
  return KC * (64 + PAD + cmax(TILE / RS, TILE / MR) + TILE / MR);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

template <typename T, int RS, int MR>
__global__ void __launch_bounds__(THREADS)
cheb2_fused_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                   const T* __restrict__ w0, const T* __restrict__ w1, T* __restrict__ y,
                   int rows_in, int C, int F, int S, int n_tiles, int pad_left, int rows_out,
                   int G) {
  constexpr int LD = RS + PAD;           // row stride of lx and of the band piece
  constexpr int CT = THREADS * 4 / RS;   // threads along the merged columns in phase 1
  constexpr int NT = 4 * CT;             // merged columns per phase-1 step
  constexpr int NC = TILE / MR;          // output columns per phase-2 step
  constexpr int SLABS = RB / RS;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int GC = G * C;
  float* lx = smem;                              // [GC][LD]: lx[m][r]
  float* As = lx + GC * LD;                      // band piece [KC][LD] | x_c [KC][MR + PAD]
  float* Xs = As + KC * (64 + PAD);              // x window [KC][NT] | w0 chunk [KC][NC]
  float* Ws = Xs + KC * cmax(NT, NC);            // w1 chunk [KC][NC]

  const int t = blockIdx.x / SLABS;
  const int r0 = (blockIdx.x % SLABS) * RS;      // first row of the slab in the tile
  const int g0 = blockIdx.y * G;                 // first sample of the group
  const int tid = threadIdx.x;

  // ---- 1. the band sum lx for the slab's rows and all G*C merged columns
  for (int l = tid; l < GC * LD; l += THREADS) lx[l] = 0.f;
  {
    const int tx = tid % CT, ty = tid / CT;      // columns 4tx.., rows 4ty..
    for (int k = 0; k < S; ++k) {
      const T* blk = blocks + (((int64_t)k * n_tiles + t) * RB + r0) * RB;
      const int row0 = (t + k) * RB - pad_left;  // x row of band column 0
      for (int j0 = 0; j0 < RB; j0 += KC) {
        bool nz = false;
        for (int l = tid; l < RS * KC; l += THREADS) {
          const int r = l / KC, jj = l % KC;
          const float v = to_f32(blk[r * RB + j0 + jj]);
          As[jj * LD + r] = v;
          nz |= (v != 0.f);
        }
        // barrier for As (and for the zeroed lx); a piece with no band
        // entry contributes nothing
        if (!__syncthreads_or(nz)) continue;
        for (int m0 = 0; m0 < GC; m0 += NT) {
          for (int l = tid; l < KC * NT; l += THREADS) {
            const int jj = l / NT, n = l % NT;
            const int m = m0 + n;
            const int r = row0 + j0 + jj;
            float v = 0.f;
            if (m < GC && r >= 0 && r < rows_in)
              v = to_f32(x[((int64_t)(g0 + m / C) * rows_in + r) * C + m % C]);
            Xs[jj * NT + n] = v;
          }
          __syncthreads();
          float acc[4][4] = {};
#pragma unroll 8
          for (int jj = 0; jj < KC; ++jj)
            fma4x4(acc, *reinterpret_cast<const float4*>(As + jj * LD + 4 * ty),
                   *reinterpret_cast<const float4*>(Xs + jj * NT + 4 * tx));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + 4 * tx + c;
            if (m >= GC) continue;
            float4* dst = reinterpret_cast<float4*>(lx + m * LD + 4 * ty);
            float4 v = *dst;
            v.x += acc[0][c]; v.y += acc[1][c]; v.z += acc[2][c]; v.w += acc[3][c];
            *dst = v;
          }
          __syncthreads();
        }
      }
    }
  }
  __syncthreads();
  // round to x's dtype: the W1 product takes lx in T, as in the TPU kernels
  if (sizeof(T) < sizeof(float)) {
    for (int l = tid; l < GC * LD; l += THREADS) lx[l] = to_f32(from_f32<T>(lx[l]));
    __syncthreads();
  }

  // ---- 2. y = x_c w0 + lx w1 over the M = G*RS rows (sample-major), MR x NC at a time
  const int tx = tid % (NC / 4), ty = tid / (NC / 4);   // columns 4tx.., rows 4ty..
  const int M = G * RS;
  const int xrow0 = t * RB + r0 - pad_left % RB;  // x row under the slab's first row
  for (int mc = 0; mc < M; mc += MR) {
    const int mt = mc + 4 * ty;                   // this thread's first row of M
    const bool valid = mt < M;
    const int tg = mt / RS, tr = mt % RS;         // its sample and slab row (4 rows, one sample)
    for (int f0 = 0; f0 < F; f0 += NC) {
      float acc0[4][4] = {}, acc1[4][4] = {};
      for (int c0 = 0; c0 < C; c0 += KC) {
        const int kw = min(KC, C - c0);
        for (int l = tid; l < KC * MR; l += THREADS) {
          const int m = l / KC, jj = l % KC;
          const int g = (mc + m) / RS, xr = xrow0 + (mc + m) % RS;
          float v = 0.f;
          if (mc + m < M && jj < kw && xr >= 0 && xr < rows_in)
            v = to_f32(x[((int64_t)(g0 + g) * rows_in + xr) * C + c0 + jj]);
          As[jj * (MR + PAD) + m] = v;
        }
        for (int l = tid; l < KC * NC; l += THREADS) {
          const int jj = l / NC, n = l % NC;
          const bool in = jj < kw && f0 + n < F;
          const int64_t at = (int64_t)(c0 + jj) * F + f0 + n;
          Xs[l] = in ? to_f32(w0[at]) : 0.f;
          Ws[l] = in ? to_f32(w1[at]) : 0.f;
        }
        __syncthreads();
        const float* lxg = lx + (tg * C + c0) * LD + tr;
        for (int jj = 0; jj < kw; ++jj) {
          const float4 b0 = *reinterpret_cast<const float4*>(Xs + jj * NC + 4 * tx);
          const float4 b1 = *reinterpret_cast<const float4*>(Ws + jj * NC + 4 * tx);
          fma4x4(acc0, *reinterpret_cast<const float4*>(As + jj * (MR + PAD) + 4 * ty), b0);
          const float4 a1 = valid ? *reinterpret_cast<const float4*>(lxg + jj * LD)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          fma4x4(acc1, a1, b1);
        }
        __syncthreads();
      }
      // ---- 3. one write of y
      if (!valid) continue;
      T* yg = y + (int64_t)(g0 + tg) * rows_out * F;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = t * RB + r0 + tr + r;
        if (row >= rows_out) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = f0 + 4 * tx + c;
          if (f < F) yg[(int64_t)row * F + f] = from_f32<T>(acc0[r][c] + acc1[r][c]);
        }
      }
    }
  }
}

template <typename T, int RS, int MR>
int launch(const void* x, const void* blocks, const void* w0, const void* w1, void* y, int B,
           int rows_in, int C, int F, int S, int n_tiles, int pad_left, int rows_out, int G,
           cudaStream_t s) {
  const int smem = 4 * (G * C * (RS + PAD) + fixed_floats(RS, MR));
  auto kernel = cheb2_fused_kernel<T, RS, MR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles * (RB / RS), B / G);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(blocks), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<T*>(y), rows_in, C, F, S, n_tiles, pad_left,
      rows_out, G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* blocks, const void* w0, const void* w1, void* y, int B,
             int rows_in, int C, int F, int S, int n_tiles, int pad_left, int rows_out, int G,
             cudaStream_t s) {
  const int64_t GC = (int64_t)G * C;
  // projection rows: the group's slab rows, at most 64 (a last, partial row
  // tile is masked)
  auto rows = [&](int RS) { return G * RS >= 64 ? 64 : G * RS >= 32 ? 32 : 16; };
  auto bytes = [&](int RS) { return 4 * (GC * (RS + PAD) + fixed_floats(RS, rows(RS))); };
  constexpr int64_t HALF_SM = SMEM_MAX / 2 - 1024;   // two blocks per SM
  int RS = bytes(64) <= HALF_SM ? 64 : bytes(32) <= HALF_SM ? 32 : 16;
  if (bytes(RS) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // smaller slabs while the grid leaves fewer than two blocks per SM (132 SMs on an H100)
  while (RS > 16 && (int64_t)n_tiles * (RB / RS) * (B / G) < 2 * 132) RS /= 2;
  const int MR = rows(RS);
#define CAPE_FUSED(RS_, MR_)                                                                  \
  if (RS == RS_ && MR == MR_)                                                                 \
    return launch<T, RS_, MR_>(x, blocks, w0, w1, y, B, rows_in, C, F, S, n_tiles, pad_left, \
                               rows_out, G, s);
  CAPE_FUSED(64, 64) CAPE_FUSED(32, 64) CAPE_FUSED(32, 32)
  CAPE_FUSED(16, 64) CAPE_FUSED(16, 32) CAPE_FUSED(16, 16)
#undef CAPE_FUSED
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], blocks [S, n_tiles,
// 128, 128], w0 and w1 [C, F] and y [B, rows_out, F] are contiguous, in that
// dtype, on the device of `stream`; G divides B, and G*C <= 1977 (2284 with
// G >= 4). Returns the launch's cudaError_t (0 = launched).
extern "C" int cape_cheb2_fused(const void* x, const void* blocks, const void* w0,
                                const void* w1, void* y, int dtype, int B, int rows_in, int C,
                                int F, int S, int n_tiles, int pad_left, int rows_out, int G,
                                void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || S <= 0 || n_tiles <= 0 || rows_in < 0 || pad_left < 0 ||
      rows_out <= 0 || rows_out > n_tiles * RB || G <= 0 || B % G != 0 || B / G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, blocks, w0, w1, y, B, rows_in, C, F, S, n_tiles, pad_left, rows_out, G, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, blocks, w0, w1, y, B, rows_in, C, F, S, n_tiles, pad_left, rows_out, G, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
