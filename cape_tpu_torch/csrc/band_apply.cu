// Banded shifted-block apply for Hopper (sm_90a), batch-major.
//
//   y[b, t*128 + i, c] = sum_k sum_j blocks[k, t, i, j] * x[b, (t+k)*128 + j - pad_left, c]
//                        (+ r[b, t*128 + i, c] when an addend r is given)
//
// for output rows t*128 + i < rows_out; rows of x outside [0, rows_in) read
// as zero (masked here, never read out of bounds).
//
// Replaces the TPU kernel `_pallas_band_apply_v2` (cape_tpu/ops/pallas/
// cheb_kernel.py, body `_kernel_v2`), which the large-batch K=2 Chebyshev
// conv `cheb2_banded_pallas_v3` runs in both directions: in its forward pass
// (y = L~x, no addend) and in its backward pass `_v3_bwd`, where the input
// gradient dx = g W0^T + L~(g W1^T) is this apply of g W1^T with the addend
// r = g W0^T, read in the epilogue so that dx is written once (L~ is
// symmetric, so the forward blocks serve the transpose). The TPU version
// transposes activations to vertex-major [V, B*C] to fill its 128-lane
// tiles and walks the S band shifts as a sequential grid axis that carries
// an f32 scratch sum. Here the kernel reads and writes batch-major [B, P, C]
// directly: columns m = b*C + c are contiguous along C, so loads and stores
// coalesce, and the shift axis is a loop inside the block.
//
// Schedule: one block of 256 threads per (row tile t, tile of NT=64 columns).
// The block keeps the 128 x 64 output tile in registers as f32 (8 rows x 4
// columns per thread) and steps over S shifts x 4 slabs of KC=32 band
// columns: each step stages a 128x32 slab of blocks[k, t] and the matching
// 32 x 64 rows of x in shared memory (both as f32), then runs 32 FMAs per
// thread per band column. Accumulation is f32 in every dtype; the addend is
// added in f32 and the output is rounded once to x's dtype (f32 or bf16).
// The addend costs one more read of the output's size, in the epilogue.
//
// What bounds it: the blocks are dense 128x128 tiles of a mesh Laplacian
// that is about 1% non-zero (~6 neighbours per row against S*128 = 640
// dense MACs per row), so the kernel does ~100x the necessary arithmetic
// and is bound by the FMA rate of the CUDA cores, not by memory: at
// [32, 6912, 64] with S=5 it runs 2*5*128*6912*2048 = 18 GFLOP (dense
// tiles) while reading 57 MB of activations. A slab whose 128x32 band
// entries are all zero is skipped as a whole (one __syncthreads_or per
// slab), which drops the slabs outside the band's diagonal: about half of
// them on the flagship pyramid. A sparse (gather) formulation, or
// tensor-core MMA on the dense tiles, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RB = 128;          // rows per band block, and its column width
constexpr int NT = 64;           // output columns (b*C + c) per block
constexpr int KC = 32;           // band columns per shared-memory step
constexpr int THREADS = 256;
constexpr int TR = RB / 16;      // output rows per thread
constexpr int TC = NT / 16;      // output columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_apply_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                  const T* __restrict__ addend, T* __restrict__ y, int rows_in, int C,
                  int M, int S, int n_tiles, int pad_left, int rows_out) {
  __shared__ float As[RB][KC + 1];   // +1: rows 16 apart fall in different banks
  __shared__ float Xs[KC][NT];

  const int t = blockIdx.x;
  const int m0 = blockIdx.y * NT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;           // output columns tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;           // output rows ty, ty+16, ..., ty+112

  // each thread stages the same x column at every step
  const int ln = tid % NT;
  const int lm = m0 + ln;
  const bool lvalid = lm < M;
  const int64_t lbase = lvalid ? (int64_t)(lm / C) * rows_in * C + (lm % C) : 0;

  float acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < S; ++k) {
    const T* blk = blocks + ((int64_t)k * n_tiles + t) * RB * RB;
    const int row0 = (t + k) * RB - pad_left;     // x row of band column 0
    for (int j0 = 0; j0 < RB; j0 += KC) {
      bool nz = false;
      for (int l = tid; l < RB * KC; l += THREADS) {
        const int i = l / KC, jj = l % KC;
        const float v = to_f32(blk[i * RB + j0 + jj]);
        As[i][jj] = v;
        nz |= (v != 0.f);
      }
      // barrier for As; a slab with no band entry contributes nothing
      if (!__syncthreads_or(nz)) continue;
      for (int jj = tid / NT; jj < KC; jj += THREADS / NT) {
        const int r = row0 + j0 + jj;
        float v = 0.f;
        if (lvalid && r >= 0 && r < rows_in) v = to_f32(x[lbase + (int64_t)r * C]);
        Xs[jj][ln] = v;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float a[TR], b[TC];
#pragma unroll
        for (int r = 0; r < TR; ++r) a[r] = As[ty + 16 * r][jj];
#pragma unroll
        for (int c = 0; c < TC; ++c) b[c] = Xs[jj][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int m = m0 + tx + 16 * c;
    if (m >= M) continue;
    const int64_t base = (int64_t)(m / C) * rows_out * C + (m % C);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = t * RB + ty + 16 * r;
      if (row >= rows_out) continue;
      const int64_t at = base + (int64_t)row * C;
      float v = acc[r][c];
      if (addend != nullptr) v += to_f32(addend[at]);
      y[at] = from_f32<T>(v);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], blocks [S, n_tiles,
// 128, 128], y [B, rows_out, C] and the optional addend (nullptr for none;
// else [B, rows_out, C], not aliasing y) are contiguous, in that dtype, on
// the device of `stream`. Returns the launch's cudaError_t (0 = launched).
extern "C" int cape_band_apply(const void* x, const void* blocks, const void* addend,
                               void* y, int dtype, int B, int rows_in, int C, int S, int n_tiles,
                               int pad_left, int rows_out, void* stream) {
  if (B <= 0 || C <= 0 || S <= 0 || n_tiles <= 0 || rows_in < 0 || pad_left < 0 ||
      rows_out <= 0 || rows_out > n_tiles * RB)
    return (int)cudaErrorInvalidValue;
  const int M = B * C;
  const dim3 grid(n_tiles, (M + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    band_apply_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(blocks),
        static_cast<const float*>(addend), static_cast<float*>(y),
        rows_in, C, M, S, n_tiles, pad_left, rows_out);
  } else if (dtype == 1) {
    band_apply_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(blocks),
        static_cast<const __nv_bfloat16*>(addend), static_cast<__nv_bfloat16*>(y),
        rows_in, C, M, S, n_tiles, pad_left, rows_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
