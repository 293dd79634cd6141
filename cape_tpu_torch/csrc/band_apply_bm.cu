// Batch-major banded apply with any column block, for Hopper (sm_90a).
//
//   y[b, t*128 + i, c] = sum_k sum_j blocks[k, t, i, j] * x[b, (t+k)*cb + j - pad_left, c]
//
// for output rows t*128 + i < n_rows, j < cb; rows of x outside [0, rows_in)
// read as zero (masked here, never read out of bounds).
//
// Replaces the TPU kernel `banded_apply_bm` (cape_tpu/ops/pallas/
// cheb_kernel.py, body `_make_kernel_bm`, "v4"): a grid over row tiles in
// which each step brings in the S shifted x windows [B, cb, C] and the S
// band blocks of its tile once, and loops over the batch, so the band blocks
// are read once per tile and not once per sample. It is the only TPU kernel
// that applies a banded operator with any column block cb: the pools of the
// pyramid (cb = 256, S = 2-6 on the flagship), the unpools (cb = 64,
// S = 6-12) and the Laplacians (cb = 128). The square-only band-apply kernel
// (band_apply.cu) takes cb = 128 alone.
//
// Schedule: one block of 256 threads per (row tile t, chunk of CC = 4
// channels, pass of up to BP = 32 samples); every batch of at most 32
// samples is one pass, so the block walks the whole batch. Thread (i, h)
// owns output row i of the tile and the samples h, h+2, h+4, ... of the
// pass, 16 samples x 4 channels of f32 sums held in registers from the
// first shift to the last. The block steps over the S shifts and, in each,
// over pieces of KC = 32 band columns (the last piece of an odd cb such as
// 65 or 254 is narrower): it stages the 128 x KC piece of blocks[k, t] in
// shared memory once, as f32, and with it the matching KC x-rows of every
// sample of the pass, then every thread runs its 16 x 4 FMAs per band
// column. The staged band piece thus serves all the samples of the pass.
// Accumulation is f32 in every dtype; one rounding to x's dtype (f32 or
// bf16) at the end.
//
// What bounds it: the band blocks are dense tiles of mesh operators that
// are well under 1% non-zero (about 7 entries a row for a Laplacian, 3 for
// an unpool), so arithmetic on them as dense tiles is ~100x the necessary
// work; at the flagship up[1] (S = 12, cb = 64, [32, 3456, 64] -> [32, 6912,
// 64]) dense tiles would be 22 GFLOP against 85 MB of activations. Two
// skips take most of it away: a piece whose 128 x KC entries are all zero is
// skipped as a whole (one __syncthreads_or), before its x rows are staged;
// inside a piece, a thread skips a band column whose entry in its row is
// zero, and since a warp holds 32 consecutive rows of a banded matrix its
// non-zeros cluster on few columns, so most columns are skipped by the
// whole warp. What remains is bound by reading each non-zero band piece
// from L2 once per channel chunk and by the strided 4-channel x reads; a
// gather (CSR) form of the tiles is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RB = 128;          // rows per band block
constexpr int KC = 32;           // band columns per shared-memory piece
constexpr int CC = 4;            // channels per block
constexpr int BP = 32;           // samples per pass
constexpr int SPT = BP / 2;      // samples per thread
constexpr int THREADS = 2 * RB;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
band_apply_bm_kernel(const T* __restrict__ x, const T* __restrict__ blocks, T* __restrict__ y,
                     int B, int rows_in, int C, int S, int n_tiles, int cb, int pad_left,
                     int n_rows) {
  __shared__ float As[RB][KC + 1];           // +1: the 32 rows of a warp hit 32 banks
  __shared__ float4 Xs[BP][KC];              // [sample][band column] -> 4 channels

  const int t = blockIdx.x;
  const int c0 = blockIdx.y * CC;
  const int b0 = blockIdx.z * BP;
  const int tid = threadIdx.x;
  const int i = tid % RB;                    // output row of the tile
  const int h = tid / RB;                    // samples h, h+2, ... of the pass
  const int nb = min(BP, B - b0);            // samples in this pass

  float acc[SPT][CC];
#pragma unroll
  for (int s = 0; s < SPT; ++s)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[s][c] = 0.f;

  for (int k = 0; k < S; ++k) {
    const T* blk = blocks + ((int64_t)k * n_tiles + t) * RB * cb;
    const int row0 = (t + k) * cb - pad_left;    // x row of band column 0
    for (int j0 = 0; j0 < cb; j0 += KC) {
      const int kw = min(KC, cb - j0);
      bool nz = false;
      for (int l = tid; l < RB * KC; l += THREADS) {
        const int r = l / KC, jj = l % KC;
        const float v = jj < kw ? to_f32(blk[(int64_t)r * cb + j0 + jj]) : 0.f;
        As[r][jj] = v;
        nz |= (v != 0.f);
      }
      // barrier for As; a piece with no band entry contributes nothing
      if (!__syncthreads_or(nz)) continue;
      for (int l = tid; l < BP * KC; l += THREADS) {
        const int bl = l / KC, jj = l % KC;
        const int r = row0 + j0 + jj;
        float v[CC] = {0.f, 0.f, 0.f, 0.f};
        if (bl < nb && jj < kw && r >= 0 && r < rows_in) {
          const T* src = x + ((int64_t)(b0 + bl) * rows_in + r) * C + c0;
#pragma unroll
          for (int c = 0; c < CC; ++c)
            if (c0 + c < C) v[c] = to_f32(src[c]);
        }
        Xs[bl][jj] = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      for (int jj = 0; jj < kw; ++jj) {
        const float a = As[i][jj];
        if (a == 0.f) continue;
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          if (h + 2 * s >= nb) break;
          const float4 xv = Xs[h + 2 * s][jj];   // the same address across the warp
          acc[s][0] = fmaf(a, xv.x, acc[s][0]);
          acc[s][1] = fmaf(a, xv.y, acc[s][1]);
          acc[s][2] = fmaf(a, xv.z, acc[s][2]);
          acc[s][3] = fmaf(a, xv.w, acc[s][3]);
        }
      }
      __syncthreads();
    }
  }

  const int row = t * RB + i;
  if (row >= n_rows) return;
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int bl = h + 2 * s;
    if (bl >= nb) continue;
    T* dst = y + ((int64_t)(b0 + bl) * n_rows + row) * C + c0;
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c0 + c < C) dst[c] = from_f32<T>(acc[s][c]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], blocks [S, n_tiles,
// 128, cb] and y [B, n_rows, C] are contiguous, in that dtype, on the device
// of `stream`. Returns the launch's cudaError_t (0 = launched).
extern "C" int cape_band_apply_bm(const void* x, const void* blocks, void* y, int dtype, int B,
                                  int rows_in, int C, int S, int n_tiles, int cb, int pad_left,
                                  int n_rows, void* stream) {
  if (B <= 0 || C <= 0 || S <= 0 || n_tiles <= 0 || cb <= 0 || rows_in < 0 || pad_left < 0 ||
      n_rows <= 0 || n_rows > n_tiles * RB)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, (C + CC - 1) / CC, (B + BP - 1) / BP);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    band_apply_bm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(blocks), static_cast<float*>(y),
        B, rows_in, C, S, n_tiles, cb, pad_left, n_rows);
  } else if (dtype == 1) {
    band_apply_bm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(blocks),
        static_cast<__nv_bfloat16*>(y), B, rows_in, C, S, n_tiles, cb, pad_left, n_rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
