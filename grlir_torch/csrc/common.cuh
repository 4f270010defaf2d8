// Device helpers shared by the block-half attention kernels.
//
// Both kernels run 256 threads a block and compute in fp32 on CUDA cores.
// Operands of every product are rounded to the input type first (bf16 when
// x is bf16), exactly as the TPU kernels cast their matmul operands, so the
// fp32 products and sums reproduce bf16-operand, fp32-accumulate numerics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace grlir {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;       // tokens projected per tile
constexpr int kChunkC = 32;         // input channels staged per step
constexpr int kColsPerPass = 128;   // projection columns per pass
constexpr int kXsLd = kTileRows + 1;
// floats of shared scratch that project_tile needs
constexpr int kProjScratch = kChunkC * kXsLd + kChunkC * kColsPerPass;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a value to the matmul operand type T and back.
template <typename T> __device__ __forceinline__ float round_mm(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[r * ldo + j] = sum_c x[pix[r] * C + c] * w[c * ldw + cols[j]] + b[cols[j]]
// for r < nrows (<= kTileRows) and j < ncols.  pix holds each row's pixel
// index in x, cols the projection column of each output.  x chunks are staged
// transposed and w chunks row-major in `scratch` (kProjScratch floats); each
// thread keeps a 4 x 8 register tile.  Ends with the block synchronised.
template <typename T>
__device__ void project_tile(const T* __restrict__ x, const int* pix, int nrows, int C,
                             const T* __restrict__ w, int ldw, const float* __restrict__ b,
                             const int* cols, int ncols, float* scratch, float* out,
                             int ldo) {
  float* xs = scratch;                        // [kChunkC][kXsLd]
  float* ws = scratch + kChunkC * kXsLd;      // [kChunkC][kColsPerPass]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int col0 = 0; col0 < ncols; col0 += kColsPerPass) {
    const int npass = min(kColsPerPass, ncols - col0);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunkC) {
      const int nc = min(kChunkC, C - c0);
      for (int i = tid; i < kChunkC * kTileRows; i += kThreads) {
        const int cc = i % kChunkC, r = i / kChunkC;
        float v = 0.f;
        if (cc < nc && r < nrows) v = to_f(x[(size_t)pix[r] * C + c0 + cc]);
        xs[cc * kXsLd + r] = v;
      }
      for (int i = tid; i < kChunkC * kColsPerPass; i += kThreads) {
        const int cc = i / kColsPerPass, j = i % kColsPerPass;
        float v = 0.f;
        if (cc < nc && j < npass) v = to_f(w[(size_t)(c0 + cc) * ldw + cols[col0 + j]]);
        ws[cc * kColsPerPass + j] = v;
      }
      __syncthreads();
      for (int cc = 0; cc < nc; ++cc) {
        float a[4], bb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[cc * kXsLd + ty + 16 * i];
#pragma unroll
        for (int k = 0; k < 8; ++k) bb[k] = ws[cc * kColsPerPass + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(a[i], bb[k], acc[i][k]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = ty + 16 * i, j = col0 + tx + 16 * k;
        if (r < nrows && j < ncols) out[r * ldo + j] = acc[i][k] + b[cols[j]];
      }
  }
  __syncthreads();
}

// Scale each row of t (rows x d, row stride ld) to unit L2 norm, as
// t * rsqrt(max(sum t^2, 1e-24)), then by `scale`, and round to T.  One warp
// per row.  Caller synchronises.
template <typename T>
__device__ void normalize_rows(float* t, int rows, int d, int ld, float scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = t + r * ld;
    float ss = 0.f;
    for (int e = lane; e < d; e += 32) ss = fmaf(row[e], row[e], ss);
    const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
    for (int e = lane; e < d; e += 32) row[e] = round_mm<T>(row[e] * inv * scale);
  }
}

}  // namespace grlir
