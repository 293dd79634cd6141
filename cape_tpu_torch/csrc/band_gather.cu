// Row-gather band apply for Hopper (sm_90a), batch-major.
//
//   y[b, r, :] = sum_w vals[r, w] * x[b, cols[r, w], :]   (+ addend[b, r, :])
//
// for output rows r < rows_out, over the gather pack of a banded operator
// (cape_tpu_torch/ops/banded.py, `gather_pack`): for each output row the
// band's non-zeros as W (column, value) pairs in ascending column order,
// W the largest row count. Rows of x outside [0, rows_in) read as zero
// (the zero pad of the band, unused slots at column -1, columns past the
// end of x): they are masked, never read. Each value is rounded to x's
// dtype, as the dense blocks of that dtype hold it; sums are f32; the
// addend is added in f32 and y is rounded once to x's dtype (f32, bf16 or
// f16).
//
// Replaces two TPU kernels of cape_tpu/ops/pallas/cheb_kernel.py:
//   * `_pallas_band_apply_v2` (body `_kernel_v2`), the band apply that the
//     large-batch K=2 Chebyshev conv `cheb2_banded_pallas_v3` runs in its
//     forward pass (L~x) and in its backward pass `_v3_bwd`, where
//     dx = g W0^T + L~(g W1^T) is this apply of g W1^T with the addend
//     g W0^T (L~ is symmetric, so the forward pack serves the transpose);
//   * `banded_apply_bm` (body `_make_kernel_bm`), the batch-major apply of
//     a banded operator with any column block (pools, unpools, Laplacians).
// Both multiply dense 128-row band tiles on the TPU's matrix unit. The
// mesh operators are under 1.5% non-zero in those tiles (6 non-zeros a
// row on average and 9-11 at most for a Laplacian, at most 3 for an
// unpool, exactly 1 for a pool), so this kernel gathers the non-zeros
// instead.
//
// What bounds it: bytes. An output element takes ~6 multiply-adds (1 for
// a pool), and the pack (0.33 MB on the flagship) is tiny against x and y
// (113 MB at [32, 6912, 64] f32), so the least time is reading x once and
// writing y once (and reading the addend once). What the design does
// about it:
//   * Lanes run along the channels with 16-byte loads and stores (4 f32, or
//     8 bf16 or f16 channels a lane): 16 lanes cover a C = 64 f32 row of one
//     sample, so a warp moves whole 256-byte rows. A C that is not a
//     multiple of the vector width (or a pointer not 16-byte aligned)
//     takes the same kernel with one element per access.
//   * One warp owns one output row and a chunk of samples (a batch loop
//     inside the warp). The row's W pairs are loaded once, one per lane,
//     and passed to every lane with __shfl_sync into registers, where
//     they serve every sample of the chunk. W is bucketed at compile time
//     (1, 4, 12, 32) so the loads of an access are unrolled, and a pair
//     that reads the zero pad loads 16 zero bytes instead of branching, so
//     the loads do not wait on each other: up to 12 are in flight per
//     lane. A row of more than 32 pairs reads its pairs from memory in the
//     loop (no flagship operator has one).
//   * The four warps of a block own four consecutive rows, and blockIdx.x,
//     the fastest grid index, walks the rows: the blocks in flight cover
//     neighbouring rows of the same samples. The RCM order keeps a row's
//     neighbours near it, so the ~6 reads of each x row meet in L1 or in
//     the 50 MB L2 and device memory sees x about once. A chunk is as many
//     samples as make 128 accesses a warp, so the grid is several waves
//     of blocks deep and its last wave short.
//   * y, and the addend, are touched once, in the epilogue of each access.
//
// No library sparse or matrix product is called.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;                 // output rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int ITEMS_PER_WARP = 128;      // 16-byte accesses a warp aims for
constexpr unsigned FULL = 0xffffffffu;

// What a pair that reads the zero pad loads, so that no load of an access
// waits on a branch and all of its W loads are in flight together.
__device__ __align__(16) unsigned char zero16[16];

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

// One access: VEC consecutive elements of T, 16 bytes (and 16-byte
// aligned) when VEC > 1. A load keeps the raw bytes and `unpack` widens
// them to f32 where they are used, so a load in flight holds 4 registers
// in every dtype.
template <typename T, int VEC> struct Access { using raw = uint4; };
template <typename T> struct Access<T, 1> { using raw = T; };

template <typename T, int VEC>
__device__ __forceinline__ typename Access<T, VEC>::raw load_raw(const T* p) {
  return *reinterpret_cast<const typename Access<T, VEC>::raw*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Access<T, VEC>::raw& q, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(q);
  } else {
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
    if constexpr (sizeof(T) == 4) {
      static_assert(VEC == 4, "an f32 access is 4 elements");
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(u[e]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      static_assert(VEC == 8, "a bf16 access is 8 elements");
#pragma unroll
      for (int e = 0; e < 4; ++e) {        // a bf16 is the high half of its f32
        v[2 * e] = __uint_as_float(u[e] << 16);
        v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
      }
    } else {
      static_assert(std::is_same_v<T, __half> && VEC == 8, "an f16 access is 8 elements");
#pragma unroll
      for (int e = 0; e < 4; ++e) {        // two f16 a word, widened by the intrinsic
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[e]));
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_rounded(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    uint4 q;
    __half2* h = reinterpret_cast<__half2*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2half2_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// WMAX > 0: W <= WMAX pairs held in registers; WMAX == 0: any W, pairs read
// in the loop.
template <typename T, int VEC, int WMAX>
__global__ void __launch_bounds__(THREADS)
band_gather_kernel(const T* __restrict__ x, const int* __restrict__ cols,
                   const float* __restrict__ vals, const T* __restrict__ addend,
                   T* __restrict__ y, int B, int rows_in, int C, int W, int rows_out,
                   int samples_per_warp) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows_out) return;                       // the whole warp
  const int b0 = blockIdx.y * samples_per_warp;
  const int nb = min(samples_per_warp, B - b0);
  const int nv = C / VEC;                          // accesses per row of one sample
  const int items = nb * nv;
  const int64_t pr = (int64_t)r * W;

  // the row's pairs, once per warp: x offset (column * C, or -1 where the
  // pair reads the zero pad) and value rounded to x's dtype
  constexpr int NR = WMAX > 0 ? WMAX : 1;
  int off[NR];
  float val[NR];
  if constexpr (WMAX > 0) {
    int c = -1;
    float v = 0.f;
    if (lane < W) {
      c = cols[pr + lane];
      v = to_f32(from_f32<T>(vals[pr + lane]));
    }
    const int o = (c >= 0 && c < rows_in) ? c * C : -1;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      off[w] = __shfl_sync(FULL, o, w);
      val[w] = __shfl_sync(FULL, v, w);
    }
  }

  for (int i = lane; i < items; i += 32) {
    const int bl = i / nv;
    const int cv = (i - bl * nv) * VEC;
    const T* xb = x + (int64_t)(b0 + bl) * rows_in * C + cv;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if constexpr (WMAX > 0) {
      constexpr int G = WMAX > 12 ? 8 : WMAX;      // loads in flight at once
#pragma unroll
      for (int w0 = 0; w0 < WMAX; w0 += G) {
        typename Access<T, VEC>::raw q[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int o = off[w0 + g];
          q[g] = load_raw<T, VEC>(o >= 0 ? xb + o : reinterpret_cast<const T*>(zero16));
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float xv[VEC];
          unpack<T, VEC>(q[g], xv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(val[w0 + g], xv[e], acc[e]);
        }
      }
    } else {
      for (int w = 0; w < W; ++w) {
        const int c = __ldg(cols + pr + w);
        if (c < 0 || c >= rows_in) continue;
        const float a = to_f32(from_f32<T>(__ldg(vals + pr + w)));
        float xv[VEC];
        unpack<T, VEC>(load_raw<T, VEC>(xb + (int64_t)c * C), xv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(a, xv[e], acc[e]);
      }
    }
    const int64_t at = ((int64_t)(b0 + bl) * rows_out + r) * C + cv;
    if (addend != nullptr) {
      float av[VEC];
      unpack<T, VEC>(load_raw<T, VEC>(addend + at), av);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += av[e];
    }
    store_rounded<T, VEC>(y + at, acc);
  }
}

template <typename T, int VEC>
int launch_vec(const void* x, const int* cols, const float* vals, const void* addend, void* y,
               int B, int rows_in, int C, int W, int rows_out, cudaStream_t s) {
  // samples per warp: ITEMS_PER_WARP accesses (4 a lane), at least one
  // sample. The grid then holds several waves of blocks, so the last one
  // is short, and a warp's pairs still serve a few samples.
  const int spw = max(1, min(B, ITEMS_PER_WARP / (C / VEC)));
  const dim3 grid((rows_out + WARPS - 1) / WARPS, (B + spw - 1) / spw);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(addend);
  T* yt = static_cast<T*>(y);
#define CAPE_GATHER(WM)                                                                     \
  band_gather_kernel<T, VEC, WM><<<grid, THREADS, 0, s>>>(xt, cols, vals, at, yt, B, rows_in, \
                                                           C, W, rows_out, spw)
  if (W <= 1) CAPE_GATHER(1);
  else if (W <= 4) CAPE_GATHER(4);
  else if (W <= 12) CAPE_GATHER(12);
  else if (W <= 32) CAPE_GATHER(32);
  else CAPE_GATHER(0);
#undef CAPE_GATHER
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const int* cols, const float* vals, const void* addend, void* y, int B,
           int rows_in, int C, int W, int rows_out, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)y | (uintptr_t)addend;
  if (C % VEC == 0 && ptrs % 16 == 0)
    return launch_vec<T, VEC>(x, cols, vals, addend, y, B, rows_in, C, W, rows_out, s);
  return launch_vec<T, 1>(x, cols, vals, addend, y, B, rows_in, C, W, rows_out, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x [B, rows_in, C], y [B, rows_out, C] and
// the optional addend (nullptr for none; else [B, rows_out, C], not aliasing
// y) are contiguous, in that dtype; cols (int32) and vals (float32) are the
// pack's [>= rows_out, W] arrays, contiguous; all on the device of `stream`.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int cape_band_gather(const void* x, const void* cols, const void* vals,
                                const void* addend, void* y, int dtype, int B, int rows_in,
                                int C, int W, int rows_out, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0 || rows_in < 0 || rows_out <= 0 ||
      (int64_t)rows_in * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  if (dtype == 0) return launch<float>(x, c, v, addend, y, B, rows_in, C, W, rows_out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, c, v, addend, y, B, rows_in, C, W, rows_out, s);
  if (dtype == 2) return launch<__half>(x, c, v, addend, y, B, rows_in, C, W, rows_out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
