// Window half of GRL's mixed attention, one CUDA block per (window, head).
//
// Replaces the Pallas kernel `_window_block_kernel`, small-window branch
// (grlir/ops/pallas/block_attn.py:214-310, entry `fused_window_half`).  It
// reads the block input x in NHWC, applies the cyclic window shift while
// reading, projects this head's q, k and v, runs cosine attention with the
// continuous position bias and the shift-band mask, and writes the head's
// output channels in NHWC, in rolled coordinates (the caller un-rolls).
//
// What bounds it on an H100: the qkv projection is ~75% of the FLOPs
// (N*3d*C per block against 2*N*N*d for the attention at GRL-S: N=64, d=32,
// C=128), and it runs on CUDA cores, so the kernel is bound by fp32 FMA issue
// and shared-memory operand traffic, not by HBM (x is read once per head,
// the output written once).  The design keeps every intermediate (qkv, the
// logits, the probabilities) in shared memory: only x, the weights, the bias
// and y touch device memory.  The projection stages x and w in 32-channel
// chunks and keeps a 4x8 register tile per thread (12 shared loads per 32
// FMAs); attention runs one warp per query row.  Tensor cores (mma/wgmma)
// are later work.
#include <algorithm>

#include "common.cuh"

namespace grlir {

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_half_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bqkv, const float* __restrict__ scale,
                   const float* __restrict__ bias, const int* __restrict__ bands,
                   T* __restrict__ y, int H, int W, int C, int Cw, int heads, int wh,
                   int ww, int shift) {
  const int d = Cw / heads, N = wh * ww, ldq = 3 * d + 1;
  const int nWx = W / ww, nWin = (H / wh) * nWx;
  const int win = blockIdx.x % nWin, b = blockIdx.x / nWin, hh = blockIdx.y;
  const int wy = win / nWx, wx = win % nWx;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  extern __shared__ float smem[];
  int* pix = reinterpret_cast<int*>(smem);       // [kTileRows]
  int* cols = pix + kTileRows;                   // [3d]
  float* scratch = smem + kTileRows + 3 * d;     // projection scratch, then probabilities
  float* qkv = scratch + max(kProjScratch, kWarps * N);  // [N][ldq]: q | k | v

  for (int j = threadIdx.x; j < 3 * d; j += kThreads)
    cols[j] = (j / d) * Cw + hh * d + j % d;

  // 1. project q, k, v of every token, 64 tokens at a time
  for (int t0 = 0; t0 < N; t0 += kTileRows) {
    const int nt = min(kTileRows, N - t0);
    for (int r = threadIdx.x; r < nt; r += kThreads) {
      const int n = t0 + r;
      const int sy = (wy * wh + n / ww + shift) % H, sx = (wx * ww + n % ww + shift) % W;
      pix[r] = (b * H + sy) * W + sx;
    }
    __syncthreads();
    project_tile<T>(x, pix, nt, C, w, 3 * Cw, bqkv, cols, 3 * d, scratch, qkv + t0 * ldq,
                    ldq);
  }

  // 2. unit-norm q (times the logit scale) and k; round q, k, v to T
  normalize_rows<T>(qkv, N, d, ldq, scale[hh]);
  normalize_rows<T>(qkv + d, N, d, ldq, 1.f);
  for (int i = threadIdx.x; i < N * d; i += kThreads) {
    float* v = qkv + (i / d) * ldq + 2 * d + i % d;
    *v = round_mm<T>(*v);
  }
  __syncthreads();

  // 3. one warp per query row: logits, fp32 softmax, probabilities times v
  float* p = scratch + warp * N;
  const int* band = bands ? bands + (size_t)win * N : nullptr;
  for (int n = warp; n < N; n += kWarps) {
    const float* qn = qkv + n * ldq;
    const float* brow = bias + ((size_t)hh * N + n) * N;
    const int bn = band ? band[n] : 0;
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      const float* km = qkv + m * ldq + d;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(qn[e], km[e], s);
      s += brow[m];
      if (band && band[m] != bn) s += -100.f;
      p[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float e = expf(p[m] - mx);
      sum += e;
      p[m] = round_mm<T>(e);
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();
    const int sy = wy * wh + n / ww, sx = wx * ww + n % ww;
    T* out = y + ((size_t)(b * H + sy) * W + sx) * Cw + hh * d;
    for (int e = lane; e < d; e += 32) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc = fmaf(p[m], qkv[m * ldq + 2 * d + e], acc);
      out[e] = from_f<T>(acc * inv);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_window_half(const void* x, const void* w, const float* bqkv,
                       const float* scale, const float* bias, const int* bands, void* y,
                       int B, int H, int W, int C, int Cw, int heads, int wh, int ww,
                       int shift, cudaStream_t stream) {
  const int d = Cw / heads, N = wh * ww;
  const size_t smem =
      sizeof(float) *
      (kTileRows + 3 * d + std::max(kProjScratch, kWarps * N) + N * (3 * d + 1));
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return -1;
  auto kernel = window_half_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * (H / wh) * (W / ww), heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bqkv, scale, bias, bands,
      static_cast<T*>(y), H, W, C, Cw, heads, wh, ww, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grlir

// Returns 0 on success, -1 when the window does not fit in shared memory, or
// the cudaError_t of a failed launch.
extern "C" int grlir_window_half(const void* x, const void* w, const float* bqkv,
                                 const float* scale, const float* bias, const int* bands,
                                 void* y, int B, int H, int W, int C, int Cw, int heads,
                                 int wh, int ww, int shift, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_window_half<__nv_bfloat16>(x, w, bqkv, scale, bias, bands, y, B,
                                                    H, W, C, Cw, heads, wh, ww, shift, s);
  return grlir::launch_window_half<float>(x, w, bqkv, scale, bias, bands, y, B, H, W, C,
                                          Cw, heads, wh, ww, shift, s);
}

extern "C" const char* grlir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
