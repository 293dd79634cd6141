// Fused K=2 Chebyshev graph convolution for Hopper (sm_90a), batch-major,
// as one streamed GEMM whose A operand is made on the fly from the band's
// gather pack; and a windowed variant of that GEMM (`cheb2_window_kernel`,
// at the end) that gathers from x rows staged in shared memory.
//
//   lx[b, r, :] = round_T( sum_w vals[r, w] * x[b, cols[r, w], :] )
//   y[b, r, :]  = round_T( x[b, r - pad_left % 128, :] . w0 + lx[b, r, :] . w1 )
//
// for output rows r < rows_out; rows of x outside [0, rows_in) read as zero
// (masked here, never read out of bounds). The pack (cols int32 [>= rows_out,
// W], -1 for an unused slot; vals f32) is the gather pack of the band blocks
// at this pad_left (cape_tpu_torch/ops/banded.py, `gather_pack`), so lx is
// the band apply L~x. round_T rounds an f32 value to the dtype T of x (f32 or
// bf16); each pack value is rounded to T as the dense blocks of that dtype
// hold it; both products are summed in one f32 accumulator and y is rounded
// once.
//
// Replaces four TPU kernels of cape_tpu/ops/pallas/cheb_kernel.py that
// compute the same conv with the intermediate L~x kept out of device memory:
// `_pallas_cheb2_impl` (kernel 1, body `_make_kernel`: one sample per grid
// row) and `_pallas_cheb2_v5_impl` (kernel 4, body `_make_kernel_v5`: G
// samples merged into the 128 lanes against a block-diagonal kron(I_G, W)),
// here `cheb2_fused_kernel`; `_pallas_cheb2_v6_impl` (kernel 5, body
// `_make_kernel_v6`) and `_pallas_cheb2_v7_impl` (kernel 6, `_make_kernel_v7`:
// v6 with two row tiles a grid step), which walk the padded x tiles in order
// and keep those the band still needs in a VMEM ring, here
// `cheb2_window_kernel`. The block-diagonal weight is not built: it is a
// trick to fill the TPU's lanes and would cost G times the projection FLOPs.
// Blocks on the GPU run in no order, so no ring walks the sequence: each
// block stages the x rows its own tiles read instead.
//
// The conv is one GEMM per block tile: M = BM = 128 rows (G samples x R =
// 128 / G rows each; G = 1 for kernel 1, v5's group for kernel 4), N = BN
// output columns, K = 2C, with A = [x_c | round_T(L~x)] and B = [w0; w1].
// The K loop streams chunks of BK channels (32 in f32, 64 in bf16) through
// two shared-memory
// stages (one barrier a chunk):
//   * the first ceil(C / BK) chunks copy x_c's rows with cp.async (16 bytes a
//     copy, zero-filled outside x);
//   * the next ceil(C / BK) chunks make the L~x chunk: each of the tile's
//     rows gathers the x rows of its pack pairs (16-byte loads along the
//     channels, four in flight, a pad pair loading 16 zero bytes instead of
//     branching), sums in f32 and stores the chunk rounded to T. The pairs
//     are loaded into shared memory once per block, with their x offsets
//     and a count per row (the walk stops after a row's last pair that reads
//     x: ~6 of W = 9-11 on the flagship), and serve every chunk and all G
//     samples;
//   * the matching [BK, BN] chunk of w0 or w1 comes by cp.async.
// Chunk k+1's copies are issued before chunk k's product and its gather
// right after, so they overlap the product of the other resident block.
// L~x never lives whole in shared memory: the old G*C cap is gone. Where F >
// BN the gather is repeated per column tile (2W FLOP per A element against
// 2 BN in the product, ~8% at W = 10 and BN = 128). Sharing it across the
// column tiles of a thread-block cluster, four stages in bf16, two rows'
// loads in flight a thread, and producer warps beside consumer warps were
// each measured slower or no faster on an H100 (PERF.md).
//
// The product, per dtype:
//   * f32 on the CUDA cores (TF32 stays off): 256 threads, each with a TM x
//     TN register tile (8 x 8 at BN = 128), A read as float4 along K for
//     each of its rows and B as float4 along N: 16 shared loads of 16 bytes
//     per 256 FMAs.
//   * bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate)
//     with ldmatrix from padded (conflict-free) rows, 8 warps of up to 64 x
//     32 outputs each. wgmma and TMA are for a later version.
// Unaligned widths (C or F not a multiple of the 16-byte vector, e.g. the
// flagship's C = 3 and F = 1, 3) take one element per access: for x, a second
// instantiation of the kernel (XV = false) whose threads cover only the
// chunk's channels of x; for w and y, a branch in the same kernel. A partial
// last row tile (the natural layout's 6890 rows) is masked.
//
// What bounds it: at C or F >= 128 the projections' 4 C F FLOP per output
// row and sample (f32: 67 TFLOP/s on the CUDA cores); below that the bytes of
// x and y. The pack, ~10 pairs a row, is what makes the band sum cheap:
// the dense 128 x 128 band blocks are ~1% non-zero. What holds it back on
// the card: in f32 the FFMA loop itself, at about half of the peak with the
// gather and x_c loads taken out; in bf16, where the tensor cores finish a
// chunk in a few hundred cycles, the latency of the synchronous gather and
// of each chunk's barrier.
//
// The tile choices live in Python (`fused_plan` and `ring_plan` in
// cape_tpu_torch/ops/kernels/cheb_kernel.py); the entries below check that
// the plan they are given is the one this source implements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;          // rows of a block tile (G samples x R rows)
constexpr int STAGES = 2;        // shared-memory stages of the K loop
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may have

// What a pad pair loads, so that no load of a gather waits on a branch.
__device__ __align__(16) unsigned char zero16[16];

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Channels per K chunk, and shared-memory row strides (elements): A
// [BM][LDA] and B [BK][ldb(BN)]. f32 A rows are padded by 4 floats (16-byte
// aligned float4 reads along K); bf16 rows by 8 elements, so that
// ldmatrix's eight 16-byte rows fall on distinct banks. A bf16 chunk is 64
// channels: the tensor cores finish a chunk so soon that its barrier and
// copies set the pace; an f32 chunk of 32 keeps two blocks an SM.
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int VEC = 4, BK = 32, LDA = BK + 4;
  __host__ __device__ static constexpr int ldb(int bn) { return bn; }
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int VEC = 8, BK = 64, LDA = BK + 8;
  __host__ __device__ static constexpr int ldb(int bn) { return bn + 8; }
};

template <typename T>
constexpr int64_t smem_bytes(int BN, int R, int W) {
  return (int64_t)sizeof(T) * STAGES * (BM * Tile<T>::LDA + Tile<T>::BK * Tile<T>::ldb(BN)) +
         8LL * R * W + 4LL * R;   // the pairs (x offset, value) and each row's count
}

template <typename T> struct Conv {
  const T* x;
  const T* w0;
  const T* w1;
  T* y;
  int rows_in, C, F, W, shift, rows_out, G, R;
  int rdiv;    // ceil(2^16 / R), so that m / R == (m * rdiv) >> 16 for m, R <= BM
  bool wvec;   // 16-byte copies of w0, w1 (F % VEC == 0, aligned)
  bool yvec;   // vector stores of y (f32: 4, bf16: 2 elements)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of T widened to f32 (a bf16 is the high half of its f32)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[Tile<T>::VEC]) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(u[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(u[e] << 16);
      v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store16_rounded(T* p, const float (&v)[Tile<T>::VEC]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// Tile row m < BM as (its sample in the tile, its row in that sample's R
// rows). bf16 takes a multiply in place of the integer division by R: it
// shortens the address math in front of each gather's loads. f32 keeps the
// division: with the multiply, ptxas spills registers inside the BN = 128
// FFMA loop, which then runs slower on an H100 (PERF.md).
template <typename T>
__device__ __forceinline__ int2 split(const Conv<T>& p, int m) {
  if constexpr (sizeof(T) == 4) return make_int2(m / p.R, m % p.R);
  const int s = (m * p.rdiv) >> 16;
  return make_int2(s, m - s * p.R);
}

// Rows c0.. of w (w0 or w1, [C, F]), columns f0.. into dst [BK][ldb(BN)],
// zero outside, by NT threads: cp.async 16 bytes a copy where p.wvec.
template <typename T, int BN, int NT>
__device__ __forceinline__ void load_w_chunk(const Conv<T>& p, const T* src, int c0, int f0,
                                             T* dst, int tid) {
  constexpr int VEC = Tile<T>::VEC, BK = Tile<T>::BK, LDB = Tile<T>::ldb(BN);
  if (p.wvec) {
    for (int l = tid; l < BK * BN / VEC; l += NT) {
      const int k = l / (BN / VEC), n = (l % (BN / VEC)) * VEC;
      const bool in = c0 + k < p.C && f0 + n < p.F;
      cp_async16(dst + k * LDB + n, in ? src + (int64_t)(c0 + k) * p.F + f0 + n : src, in);
    }
  } else {
    for (int l = tid; l < BK * BN; l += NT) {
      const int k = l / BN, n = l % BN;
      const bool in = c0 + k < p.C && f0 + n < p.F;
      dst[k * LDB + n] = in ? src[(int64_t)(c0 + k) * p.F + f0 + n] : from_f32<T>(0.f);
    }
  }
}

// N consecutive outputs of tile row m from column n, rounded once to T.
template <typename T, int N>
__device__ __forceinline__ void put(const Conv<T>& p, int g0, int r0, int f0, int m, int n,
                                    const float (&v)[N]) {
  if (m >= p.G * p.R) return;
  const int2 sr = split(p, m);
  const int r = r0 + sr.y, f = f0 + n;
  if (r >= p.rows_out || f >= p.F) return;
  T* dst = p.y + ((int64_t)(g0 + sr.x) * p.rows_out + r) * p.F + f;
  if (p.yvec) {   // F % N == 0, so the whole vector is inside
    if constexpr (sizeof(T) == 4 && N == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (sizeof(T) == 2 && N == 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (f + e < p.F) dst[e] = from_f32<T>(v[e]);
}

// ---- f32: FFMA with a TM x TN register tile per thread
template <int BN> struct FmaTile {
  static constexpr int LDA = Tile<float>::LDA;
  static constexpr int TN = BN >= 128 ? 8 : 4;
  static constexpr int TX = BN / TN;              // threads along N
  static constexpr int TM = BM * TX / THREADS;    // rows per thread
  static_assert(TM * (THREADS / TX) == BM && (TM == 4 || TM == 8), "tile shape");

  float acc[TM][TN];
  int ty, tx;

  __device__ __forceinline__ void init(int tid) {
    ty = tid / TX;
    tx = tid % TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  // column of the thread's j-th group of 4: two groups BN/2 apart at TN = 8,
  // so that 8 neighbouring threads read 128 contiguous bytes of B
  __device__ __forceinline__ int col(int jg) const { return jg * (BN / 2) + tx * 4; }

  __device__ __forceinline__ void chunk(const float* A, const float* B) {
#pragma unroll
    for (int k4 = 0; k4 < Tile<float>::BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (ty * TM + i) * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int jg = 0; jg < TN / 4; ++jg) {
          const float4 q = *reinterpret_cast<const float4*>(B + (k4 + kk) * BN + col(jg));
          b[4 * jg] = q.x; b[4 * jg + 1] = q.y; b[4 * jg + 2] = q.z; b[4 * jg + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Conv<float>& p, int g0, int r0, int f0) const {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jg = 0; jg < TN / 4; ++jg) {
        const float v[4] = {acc[i][4 * jg], acc[i][4 * jg + 1], acc[i][4 * jg + 2],
                            acc[i][4 * jg + 3]};
        put<float, 4>(p, g0, r0, f0, ty * TM + i, col(jg), v);
      }
  }
};

// ---- bf16: mma.sync m16n8k16 on the tensor cores, ldmatrix from shared memory
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN> struct MmaTile {
  using T = __nv_bfloat16;
  static constexpr int LDA = Tile<T>::LDA, LDB = Tile<T>::ldb(BN);
  static constexpr int WARPS_N = BN >= 64 ? BN / 32 : 1, WARPS_M = THREADS / 32 / WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // a warp's outputs
  static constexpr int MI = WM / 16, NI = WN / 8;             // its m16 and n8 tiles
  static_assert(MI >= 1 && NI % 2 == 0, "warp tile");

  float acc[MI][NI][4];
  int wm, wn, lane;

  __device__ __forceinline__ void init(int tid) {
    lane = tid % 32;
    wm = tid / 32 / WARPS_N;
    wn = tid / 32 % WARPS_N;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void chunk(const T* A, const T* B) {
#pragma unroll
    for (int ks = 0; ks < Tile<T>::BK; ks += 16) {
      unsigned a[MI][4], b[NI / 2][4];
      // A: lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at k + 8
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(a[i], A + (wm * WM + i * 16 + lane % 16) * LDA + ks + (lane / 16) * 8);
      // B, stored [k][n]: transposed 8 x 8 loads give two n8 tiles' k16 fragments
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        ldsm_x4_trans(b[j], B + (ks + lane % 16) * LDB + wn * WN + j * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }

  __device__ __forceinline__ void store(const Conv<T>& p, int g0, int r0, int f0) const {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int m = wm * WM + i * 16 + lane / 4, n = wn * WN + j * 8 + 2 * (lane % 4);
        const float lo[2] = {acc[i][j][0], acc[i][j][1]}, hi[2] = {acc[i][j][2], acc[i][j][3]};
        put<T, 2>(p, g0, r0, f0, m, n, lo);
        put<T, 2>(p, g0, r0, f0, m + 8, n, hi);
      }
  }
};

template <typename T, int BN>
using Product = std::conditional_t<sizeof(T) == 4, FmaTile<BN>, MmaTile<BN>>;

// XV: 16-byte accesses of x (C % VEC == 0, x aligned), else one element an
// access; a template flag, so that the scalar path's code does not share a
// register allocation with the vector path's
template <typename T, int BN, bool XV>
__global__ void __launch_bounds__(THREADS, 2)
cheb2_fused_kernel(const Conv<T> p, const int* __restrict__ cols,
                   const float* __restrict__ vals, int n_col_tiles) {
  constexpr int VEC = Tile<T>::VEC, BK = Tile<T>::BK, LDA = Tile<T>::LDA, LDB = Tile<T>::ldb(BN);
  extern __shared__ float4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);                       // [STAGES][BM][LDA]
  T* Bs = As + STAGES * BM * LDA;                            // [STAGES][BK][LDB]
  int* offs = reinterpret_cast<int*>(Bs + STAGES * BK * LDB);  // [R][W] x offsets
  float* pv = reinterpret_cast<float*>(offs + p.R * p.W);    // [R][W] values
  int* cnt = reinterpret_cast<int*>(pv + p.R * p.W);         // [R] pairs to walk

  const int tid = threadIdx.x;
  const int f0 = (blockIdx.x % n_col_tiles) * BN;   // column tiles fastest: they share x
  const int r0 = (blockIdx.x / n_col_tiles) * p.R;
  const int g0 = blockIdx.y * p.G;
  const int M = p.G * p.R;                          // tile rows in use
  const int nC = (p.C + BK - 1) / BK;               // chunks of each half of K

  // the tile's pack pairs, once: the x offset (-1 where the pair reads the
  // zero pad or past the end of x) and the value rounded to T; per row, the
  // pairs up to its last one that reads x, which the gather walks (a row's
  // pairs are in ascending column order, unused slots last: ~6 of W = 9-11
  // on the flagship's Laplacians)
  for (int rr = tid; rr < p.R; rr += THREADS) cnt[rr] = 0;
  __syncthreads();
  for (int l = tid; l < p.R * p.W; l += THREADS) {
    const int rr = l / p.W, r = r0 + rr;
    int c = -1;
    float v = 0.f;
    if (r < p.rows_out) {
      const int64_t at = (int64_t)r * p.W + l % p.W;
      c = cols[at];
      v = to_f32(from_f32<T>(vals[at]));
    }
    const bool in = c >= 0 && c < p.rows_in;
    offs[l] = in ? c * p.C : -1;
    pv[l] = v;
    if (in) atomicMax(cnt + rr, l % p.W + 1);
  }

  // chunk kc of B: rows c0.. of w0 (kc < nC) or w1
  auto load_w = [&](int kc, T* dst) {
    load_w_chunk<T, BN, THREADS>(p, kc < nC ? p.w0 : p.w1, (kc < nC ? kc : kc - nC) * BK, f0,
                                 dst, tid);
  };
  // chunk kc < nC of A: x_c, x row r - shift under output row r; zero outside x
  auto load_xc = [&](int kc, T* dst) {
    const int c0 = kc * BK;
    constexpr int NV = BK / VEC;
    if constexpr (XV) {
      for (int l = tid; l < BM * NV; l += THREADS) {
        const int m = l / NV, k = (l % NV) * VEC;
        const int2 sr = split(p, m);
        const int xr = r0 + sr.y - p.shift;
        const bool in = m < M && xr >= 0 && xr < p.rows_in && c0 + k < p.C;
        cp_async16(dst + m * LDA + k,
                   in ? p.x + ((int64_t)(g0 + sr.x) * p.rows_in + xr) * p.C + c0 + k : p.x, in);
      }
    } else {   // one element a thread over the chunk's kw channels of x, as in gather
      const int kw = min(BK, p.C - c0);
#pragma unroll 4
      for (int l = tid; l < BM * kw; l += THREADS) {
        const int m = l / kw, k = l % kw;
        const int2 sr = split(p, m);
        const int xr = r0 + sr.y - p.shift;
        const bool in = m < M && xr >= 0 && xr < p.rows_in;
        dst[m * LDA + k] =
            in ? p.x[((int64_t)(g0 + sr.x) * p.rows_in + xr) * p.C + c0 + k] : from_f32<T>(0.f);
      }
      for (int l = tid; l < BM * (BK - kw); l += THREADS)
        dst[l / (BK - kw) * LDA + kw + l % (BK - kw)] = from_f32<T>(0.f);
    }
  };
  // chunk kc >= nC of A: round_T(L~x) over channels c0.., gathered from the pairs
  auto gather = [&](int kc, T* dst) {
    const int c0 = (kc - nC) * BK;
    if constexpr (XV) {
      constexpr int NV = BK / VEC;
      for (int l = tid; l < BM * NV; l += THREADS) {
        const int m = l / NV, k = (l % NV) * VEC;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        if (m < M && c0 + k < p.C) {
          const int2 sr = split(p, m);
          const T* xb = p.x + (int64_t)(g0 + sr.x) * p.rows_in * p.C + c0 + k;
          const int* o = offs + sr.y * p.W;
          const float* v = pv + sr.y * p.W;
          const int n = cnt[sr.y];
          for (int w0 = 0; w0 < n; w0 += 4) {   // four loads in flight
            uint4 q[4];
            float a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int w = w0 + u;
              const int ow = w < n ? o[w] : -1;
              a[u] = w < n ? v[w] : 0.f;
              q[u] = *reinterpret_cast<const uint4*>(
                  ow >= 0 ? static_cast<const void*>(xb + ow) : static_cast<const void*>(zero16));
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float xv[VEC];
              unpack<T>(q[u], xv);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] = fmaf(a[u], xv[e], acc[e]);
            }
          }
        }
        store16_rounded<T>(dst + m * LDA + k, acc);
      }
    } else {
      // one element a thread over the kw channels of x in this chunk, so
      // that every thread gathers where C < BK (the flagship's C = 3); the
      // chunk's other channels are zero
      const int kw = min(BK, p.C - c0);
      for (int l = tid; l < BM * kw; l += THREADS) {
        const int m = l / kw, k = l % kw;
        float acc = 0.f;
        if (m < M) {
          const int2 sr = split(p, m);
          const T* xb = p.x + (int64_t)(g0 + sr.x) * p.rows_in * p.C + c0 + k;
          const int* o = offs + sr.y * p.W;
          const float* v = pv + sr.y * p.W;
          const int n = cnt[sr.y];
#pragma unroll 4
          for (int w = 0; w < n; ++w) {
            const int ow = o[w];
            acc = fmaf(v[w], ow >= 0 ? to_f32(xb[ow]) : 0.f, acc);
          }
        }
        dst[m * LDA + k] = from_f32<T>(acc);
      }
      for (int l = tid; l < BM * (BK - kw); l += THREADS)
        dst[l / (BK - kw) * LDA + kw + l % (BK - kw)] = from_f32<T>(0.f);
    }
  };

  Product<T, BN> prod;
  prod.init(tid);
  const int nK = 2 * nC;
  load_xc(0, As);
  load_w(0, Bs);
  cp_async_commit();
  for (int kc = 0; kc < nK; ++kc) {
    cp_async_wait_all();
    __syncthreads();   // chunk kc is in its stage; the other stage is free
    const int nx = kc + 1;
    T* An = As + (nx % STAGES) * BM * LDA;
    if (nx < nK) {
      load_w(nx, Bs + (nx % STAGES) * BK * LDB);
      if (nx < nC) load_xc(nx, An);
    }
    cp_async_commit();
    prod.chunk(As + (kc % STAGES) * BM * LDA, Bs + (kc % STAGES) * BK * LDB);
    if (nx < nK && nx >= nC) gather(nx, An);
  }
  prod.store(p, g0, r0, f0);
}

template <typename T, int BN>
int launch(const Conv<T>& p, bool xvec, const int* cols, const float* vals, int grid_x,
           int grid_y, int smem, cudaStream_t s) {
  auto kernel = xvec ? cheb2_fused_kernel<T, BN, true> : cheb2_fused_kernel<T, BN, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, grid_y), THREADS, smem, s>>>(p, cols, vals, (p.F + BN - 1) / BN);
  return (int)cudaGetLastError();
}

// Sets p's vector flags for w and y; returns whether x takes 16-byte accesses.
template <typename T>
bool vector_flags(Conv<T>& p) {
  constexpr int VEC = Tile<T>::VEC;
  const uintptr_t w = (uintptr_t)p.w0 | (uintptr_t)p.w1;
  p.wvec = p.F % VEC == 0 && w % 16 == 0;
  p.yvec = sizeof(T) == 4 ? p.F % 4 == 0 && (uintptr_t)p.y % 16 == 0
                          : p.F % 2 == 0 && (uintptr_t)p.y % 4 == 0;
  return p.C % VEC == 0 && (uintptr_t)p.x % 16 == 0;
}

template <typename T>
int dispatch(Conv<T> p, const int* cols, const float* vals, int B, int BN, int grid_x,
             int grid_y, int smem, cudaStream_t s) {
  // the plan must be the one this source implements (fused_plan in Python)
  const int64_t want_x = (int64_t)((p.F + BN - 1) / BN) * ((p.rows_out + p.R - 1) / p.R);
  if (p.R < 1 || p.G * p.R > BM || want_x != grid_x || grid_y != B / p.G ||
      smem != smem_bytes<T>(BN, p.R, p.W) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const bool xvec = vector_flags(p);
  if constexpr (sizeof(T) == 4) {
    if (BN == 128) return launch<T, 128>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
    if (BN == 64) return launch<T, 64>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
    if (BN == 32) return launch<T, 32>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
  } else {
    if (BN == 128) return launch<T, 128>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
    if (BN == 64) return launch<T, 64>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
    if (BN == 32) return launch<T, 32>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
    if (BN == 16) return launch<T, 16>(p, xvec, cols, vals, grid_x, grid_y, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* x, const void* cols, const void* vals, const void* w0, const void* w1,
        void* y, int B, int rows_in, int C, int F, int W, int pad_left, int rows_out, int G, int BN,
        int R, int grid_x, int grid_y, int smem, cudaStream_t s) {
  Conv<T> p{static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(w1),
            static_cast<T*>(y), rows_in, C, F, W, pad_left % BM, rows_out, G, R,
            R > 0 ? (65536 + R - 1) / R : 0, false, false};
  return dispatch<T>(p, static_cast<const int*>(cols), static_cast<const float*>(vals), B, BN,
                     grid_x, grid_y, smem, s);
}

// ---- the windowed conv (TPU kernels 5 and 6)
//
// The same function over `tiles` consecutive 128-row output tiles per block
// (1 for kernel 5, 2 for kernel 6), one sample, BN output columns. The x
// rows those tiles read, their pack columns and their own rows (the
// centre, row r - shift under output row r), form one span [lo, hi), the
// group's window, built with the pack (`row_windows` in
// cape_tpu_torch/ops/banded.py; 218-667 rows on the flagship). Per chunk of
// BK channels the block copies the window's rows into shared memory by
// cp.async (each row once, zero outside x), gathers the L~x chunk of its
// rows from there with the pairs' offsets taken relative to lo, and runs
// both products on the product tiles above: x_c read in place from the
// window (the same row stride as A), then L~x. Chunk c + 1's window and
// weight copies are issued once chunk c's gather and x_c product are done,
// so they overlap its L~x product. At tiles = 2 the block is two groups of
// 256 threads, each with its own product tile and 128-row tile, sharing
// the window, the pairs and the copies. The window takes most of the
// block's shared memory (up to ~96 KB of ~210 KB): one block an SM.
template <typename T>
constexpr int64_t window_smem_bytes(int BN, int tiles, int W, int window_rows) {
  return (int64_t)sizeof(T) * ((int64_t)(window_rows + tiles * BM) * Tile<T>::LDA +
                               3LL * Tile<T>::BK * Tile<T>::ldb(BN)) +
         8LL * tiles * BM * W + 4LL * tiles * BM;
}

template <typename T, int BN, bool XV, int TILES>
__global__ void __launch_bounds__(TILES * THREADS, 1)
cheb2_window_kernel(const Conv<T> p, const int* __restrict__ cols,
                    const float* __restrict__ vals, const int* __restrict__ windows,
                    int window_rows, int n_col_tiles) {
  constexpr int VEC = Tile<T>::VEC, BK = Tile<T>::BK, LDA = Tile<T>::LDA, LDB = Tile<T>::ldb(BN);
  constexpr int NT = TILES * THREADS, ROWS = TILES * BM;
  extern __shared__ float4 smem4[];
  T* Xw = reinterpret_cast<T*>(smem4);                         // [window_rows][LDA]
  T* As = Xw + window_rows * LDA;                              // [ROWS][LDA] L~x
  T* Bs = As + ROWS * LDA;                                     // [3][BK][LDB] w0, w1, w1
  int* offs = reinterpret_cast<int*>(Bs + 3 * BK * LDB);       // [ROWS][W] window offsets
  float* pv = reinterpret_cast<float*>(offs + ROWS * p.W);     // [ROWS][W] values
  int* cnt = reinterpret_cast<int*>(pv + ROWS * p.W);          // [ROWS] pairs to walk

  const int tid = threadIdx.x;
  const int grp = blockIdx.x / n_col_tiles;
  const int f0 = (blockIdx.x % n_col_tiles) * BN;
  const int r0 = grp * ROWS;
  const int b = blockIdx.y;
  const int nC = (p.C + BK - 1) / BK;
  // the window's first row, from the pack's windows (read again where it is
  // needed: values held across the K loop spill the BN = 128 product tiles)
  auto window_lo = [&] { return __ldg(windows + 2 * (blockIdx.x / n_col_tiles)); };

  // chunk c0.. of the window: x rows lo + i for i < nw, zero outside x
  auto load_window = [&](int c0) {
    const int lo = window_lo(), nw = __ldg(windows + 2 * (blockIdx.x / n_col_tiles) + 1) - lo;
    const T* xb = p.x + (int64_t)blockIdx.y * p.rows_in * p.C;
    if constexpr (XV) {
      constexpr int NV = BK / VEC;
      for (int l = tid; l < nw * NV; l += NT) {
        const int i = l / NV, k = (l % NV) * VEC, xr = lo + i;
        const bool in = xr >= 0 && xr < p.rows_in && c0 + k < p.C;
        cp_async16(Xw + i * LDA + k, in ? xb + (int64_t)xr * p.C + c0 + k : p.x, in);
      }
    } else {   // one element a thread over the chunk's kw channels of x
      const int kw = min(BK, p.C - c0);
      for (int l = tid; l < nw * kw; l += NT) {
        const int i = l / kw, k = l % kw, xr = lo + i;
        Xw[i * LDA + k] =
            xr >= 0 && xr < p.rows_in ? xb[(int64_t)xr * p.C + c0 + k] : from_f32<T>(0.f);
      }
      for (int l = tid; l < nw * (BK - kw); l += NT)
        Xw[l / (BK - kw) * LDA + kw + l % (BK - kw)] = from_f32<T>(0.f);
    }
  };
  auto load_w = [&](const T* src, int c0, T* dst) {
    load_w_chunk<T, BN, NT>(p, src, c0, f0, dst, tid);
  };
  // the L~x chunk over channels c0.., rounded to T, from the window
  auto gather = [&](int c0) {
    if constexpr (XV) {
      constexpr int NV = BK / VEC;
      for (int l = tid; l < ROWS * NV; l += NT) {
        const int m = l / NV, k = (l % NV) * VEC;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        if (c0 + k < p.C) {
          const int* o = offs + m * p.W;
          const float* v = pv + m * p.W;
          const int n = cnt[m];
          const T* xk = Xw + k;
#pragma unroll 4
          for (int w = 0; w < n; ++w) {
            const int ow = o[w];
            const uint4 q = ow >= 0 ? *reinterpret_cast<const uint4*>(xk + ow) : make_uint4(0, 0, 0, 0);
            float xv[VEC];
            unpack<T>(q, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(v[w], xv[e], acc[e]);
          }
        }
        store16_rounded<T>(As + m * LDA + k, acc);
      }
    } else {
      const int kw = min(BK, p.C - c0);
      for (int l = tid; l < ROWS * kw; l += NT) {
        const int m = l / kw, k = l % kw;
        const int* o = offs + m * p.W;
        const float* v = pv + m * p.W;
        const int n = cnt[m];
        float acc = 0.f;
#pragma unroll 4
        for (int w = 0; w < n; ++w) {
          const int ow = o[w];
          acc = fmaf(v[w], ow >= 0 ? to_f32(Xw[ow + k]) : 0.f, acc);
        }
        As[m * LDA + k] = from_f32<T>(acc);
      }
      for (int l = tid; l < ROWS * (BK - kw); l += NT)
        As[l / (BK - kw) * LDA + kw + l % (BK - kw)] = from_f32<T>(0.f);
    }
  };

  const int lo = window_lo();
  for (int rr = tid; rr < ROWS; rr += NT) cnt[rr] = 0;
  __syncthreads();
  load_window(0);
  load_w(p.w0, 0, Bs);
  load_w(p.w1, 0, Bs + BK * LDB);
  cp_async_commit();
  // the block's pack pairs, once, while chunk 0 arrives: the offset of the
  // pair's x row in the window (-1 where it reads outside x) and the value
  // rounded to T; per row, the pairs up to its last one that reads x
  for (int l = tid; l < ROWS * p.W; l += NT) {
    const int rr = l / p.W, r = r0 + rr;
    int c = -1;
    float v = 0.f;
    if (r < p.rows_out) {
      const int64_t at = (int64_t)r * p.W + l % p.W;
      c = cols[at];
      v = to_f32(from_f32<T>(vals[at]));
    }
    const bool in = c >= 0 && c < p.rows_in;
    offs[l] = in ? (c - lo) * LDA : -1;
    pv[l] = v;
    if (in) atomicMax(cnt + rr, l % p.W + 1);
  }

  // the thread's row tile (threads / THREADS): its product tile, its x_c
  // rows in the window, its L~x rows
  const bool live = r0 + tid / THREADS * BM < p.rows_out;   // a last group may hold one tile
  Product<T, BN> prod;
  prod.init(tid % THREADS);
  for (int c = 0; c < nC; ++c) {
    cp_async_wait_all();
    __syncthreads();   // chunk c's window and weights are in; L~x's stage is free
    gather(c * BK);
    if (live) prod.chunk(Xw + (r0 + tid / THREADS * BM - p.shift - window_lo()) * LDA, Bs);
    __syncthreads();   // L~x's chunk is whole; the window and w0's stage are free
    if (c + 1 < nC) {
      load_window((c + 1) * BK);
      load_w(p.w0, (c + 1) * BK, Bs);
      load_w(p.w1, (c + 1) * BK, Bs + (1 + (c + 1) % 2) * BK * LDB);
    }
    cp_async_commit();
    if (live) prod.chunk(As + tid / THREADS * BM * LDA, Bs + (1 + c % 2) * BK * LDB);
  }
  if (live) prod.store(p, b, r0 + tid / THREADS * BM, f0);
}

template <typename T, int BN, int TILES>
int launch_window(const Conv<T>& p, bool xvec, const int* cols, const float* vals,
                  const int* windows, int window_rows, int grid_x, int grid_y, int smem,
                  cudaStream_t s) {
  auto kernel = xvec ? cheb2_window_kernel<T, BN, true, TILES>
                     : cheb2_window_kernel<T, BN, false, TILES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, grid_y), TILES * THREADS, smem, s>>>(p, cols, vals, windows, window_rows,
                                                             (p.F + BN - 1) / BN);
  return (int)cudaGetLastError();
}

template <typename T, int TILES>
int launch_window_bn(const Conv<T>& p, bool xvec, int BN, const int* cols, const float* vals,
                     const int* windows, int window_rows, int grid_x, int grid_y, int smem,
                     cudaStream_t s) {
  if (BN == 128)
    return launch_window<T, 128, TILES>(p, xvec, cols, vals, windows, window_rows, grid_x, grid_y, smem, s);
  if (BN == 64)
    return launch_window<T, 64, TILES>(p, xvec, cols, vals, windows, window_rows, grid_x, grid_y, smem, s);
  if (BN == 32)
    return launch_window<T, 32, TILES>(p, xvec, cols, vals, windows, window_rows, grid_x, grid_y, smem, s);
  if constexpr (sizeof(T) == 2)
    if (BN == 16)
      return launch_window<T, 16, TILES>(p, xvec, cols, vals, windows, window_rows, grid_x, grid_y, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_window(const void* x, const void* cols, const void* vals, const void* windows,
               const void* w0, const void* w1, void* y, int B, int rows_in, int C, int F, int W,
               int pad_left, int rows_out, int tiles, int BN, int window_rows, int smem,
               int grid_x, int grid_y, cudaStream_t s) {
  // the plan must be the one this source implements (ring_plan in Python)
  const int64_t groups = ((rows_out + BM - 1) / BM + tiles - 1) / tiles;
  if ((tiles != 1 && tiles != 2) || window_rows < tiles * BM || grid_y != B ||
      grid_x != (int64_t)((F + BN - 1) / BN) * groups ||
      smem != window_smem_bytes<T>(BN, tiles, W, window_rows) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  Conv<T> p{static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(w1),
            static_cast<T*>(y), rows_in, C, F, W, pad_left % BM, rows_out, 1, BM,
            (65536 + BM - 1) / BM, false, false};
  const bool xvec = vector_flags(p);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  const int* win = static_cast<const int*>(windows);
  if (tiles == 1)
    return launch_window_bn<T, 1>(p, xvec, BN, c, v, win, window_rows, grid_x, grid_y, smem, s);
  return launch_window_bn<T, 2>(p, xvec, BN, c, v, win, window_rows, grid_x, grid_y, smem, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], w0 and w1 [C, F] and
// y [B, rows_out, F] are contiguous, in that dtype; cols (int32) and vals
// (float32) are the gather pack's [>= rows_out, W] arrays, contiguous; all on
// the device of `stream`. G divides B. The plan (block tile BM x BN, K chunk
// BK, stages, R rows per sample of a tile, shared-memory bytes, grid) is
// `fused_plan`'s; it is refused unless it is the one this source implements.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int cape_cheb2_fused(const void* x, const void* cols, const void* vals,
                                const void* w0, const void* w1, void* y, int dtype, int B,
                                int rows_in, int C, int F, int W, int pad_left, int rows_out,
                                int G, int bm, int BN, int bk, int stages, int R, int smem,
                                int grid_x, int grid_y, void* stream) {
  const int want_bk = dtype == 0 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
  if (B <= 0 || C <= 0 || F <= 0 || W <= 0 || rows_in < 0 || pad_left < 0 || rows_out <= 0 ||
      G <= 0 || B % G != 0 || B / G > 65535 || (int64_t)rows_in * C > INT32_MAX || bm != BM ||
      bk != want_bk || stages != STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, cols, vals, w0, w1, y, B, rows_in, C, F, W, pad_left, rows_out, G, BN,
                      R, grid_x, grid_y, smem, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, cols, vals, w0, w1, y, B, rows_in, C, F, W, pad_left, rows_out,
                              G, BN, R, grid_x, grid_y, smem, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. x [B, rows_in, C], w0 and w1 [C, F] and
// y [B, rows_out, F] are contiguous, in that dtype; cols (int32) and vals
// (float32) are the gather pack's [>= rows_out, W] arrays and windows
// (int32) its [groups, 2] row windows for `tiles` row tiles a group (1 or
// 2), contiguous; all on the device of `stream`. The plan (BN, BK, the
// largest window's rows, shared-memory bytes, grid) is `ring_plan`'s; it is
// refused unless it is the one this source implements. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int cape_cheb2_window(const void* x, const void* cols, const void* vals,
                                 const void* windows, const void* w0, const void* w1, void* y,
                                 int dtype, int B, int rows_in, int C, int F, int W, int pad_left,
                                 int rows_out, int tiles, int BN, int bk, int window_rows,
                                 int smem, int grid_x, int grid_y, void* stream) {
  const int want_bk = dtype == 0 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
  if (B <= 0 || B > 65535 || C <= 0 || F <= 0 || W <= 0 || rows_in < 0 || pad_left < 0 ||
      rows_out <= 0 || (int64_t)rows_in * C > INT32_MAX || bk != want_bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_window<float>(x, cols, vals, windows, w0, w1, y, B, rows_in, C, F, W, pad_left,
                             rows_out, tiles, BN, window_rows, smem, grid_x, grid_y, s);
  if (dtype == 1)
    return run_window<__nv_bfloat16>(x, cols, vals, windows, w0, w1, y, B, rows_in, C, F, W,
                                     pad_left, rows_out, tiles, BN, window_rows, smem, grid_x,
                                     grid_y, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cape_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
