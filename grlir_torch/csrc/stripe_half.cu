// Anchored-stripe half of GRL's mixed attention, one CUDA block per
// (stripe, head).
//
// Replaces the Pallas kernel `_stripe_block_kernel`, resident-bias path
// (grlir/ops/pallas/block_attn.py:589-719, entry `fused_stripe_half`).  For
// one stripe of N1 tokens and its N2 = N1/df^2 anchor tokens it computes
//   a2w: x1 = softmax_N1(norm(anchor) . (norm(k) s1)^T + bias_a2w + mask) v
//   w2a: y  = softmax_N2((norm(q) s2) . norm(anchor)^T + bias_w2a + mask) x1
// reading x in NHWC with the cyclic stripe shift applied while reading (the
// anchor arrives already rolled) and writing y in NHWC, in rolled
// coordinates.  Horizontal and vertical stripes are the same code.
//
// What bounds it on an H100: the TPU kernel keeps the whole (h, N2, N1)
// logit matrix and both biases resident (up to 4 MB); a Hopper block has at
// most 227 KB of shared memory.  So this kernel streams the N1 tokens in
// tiles of 64, twice: pass A projects k and v per tile and folds the tile
// into an online (running max and sum) softmax over N1 for every anchor
// row; pass B projects q per tile, and its softmax over N2 is complete per
// token.  Shared memory then holds one tile, the anchor and x1, whatever N1
// is.  As in the window kernel the qkv projection dominates the FLOPs and
// runs on CUDA cores in fp32 (bf16-rounded operands), so FMA issue and
// shared-memory traffic bound it, not HBM.  Tensor cores are later work.
#include <algorithm>

#include "common.cuh"

namespace grlir {

template <typename T>
__global__ void __launch_bounds__(kThreads)
stripe_half_kernel(const T* __restrict__ x, const T* __restrict__ anchor,
                   const T* __restrict__ w, const float* __restrict__ bqkv,
                   const float* __restrict__ scale1, const float* __restrict__ scale2,
                   const float* __restrict__ bias_a2w, const float* __restrict__ bias_w2a,
                   const int* __restrict__ bands, const int* __restrict__ bands_a,
                   T* __restrict__ y, int H, int W, int C, int Cs, int heads, int sh, int sw,
                   int df, int shift_h, int shift_w) {
  const int d = Cs / heads, ah = sh / df, aw = sw / df;
  const int N1 = sh * sw, N2 = ah * aw;
  const int nSx = W / sw, nS = (H / sh) * nSx;
  const int sidx = blockIdx.x % nS, b = blockIdx.x / nS, hh = blockIdx.y;
  const int sy = sidx / nSx, sx = sidx % nSx;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ldt = 2 * d + 1, lda = d + 1, lds = kTileRows + 1;

  extern __shared__ float smem[];
  int* pix = reinterpret_cast<int*>(smem);       // [kTileRows]
  int* cols = pix + kTileRows;                   // [2d]
  float* scratch = smem + kTileRows + 2 * d;     // projection scratch / logits
  float* tile = scratch + max(kProjScratch, max(N2 * lds, kWarps * N2));  // [64][ldt]
  float* an = tile + kTileRows * ldt;            // [N2][lda] normalised anchor
  float* acc = an + N2 * lda;                    // [N2][lda] a2w sums, then x1
  float* mrow = acc + N2 * lda;                  // [N2] running max
  float* lrow = mrow + N2;                       // [N2] running sum
  const int* band = bands ? bands + (size_t)sidx * N1 : nullptr;
  const int* band_a = bands_a ? bands_a + (size_t)sidx * N2 : nullptr;

  // anchor tokens of this stripe (pre-rolled by the caller), unit-normed
  const int Ha = H / df, Wa = W / df;
  for (int i = threadIdx.x; i < N2 * d; i += kThreads) {
    const int a = i / d, e = i % d;
    const size_t p = (size_t)(b * Ha + sy * ah + a / aw) * Wa + sx * aw + a % aw;
    an[a * lda + e] = to_f(anchor[p * Cs + hh * d + e]);
    acc[a * lda + e] = 0.f;
  }
  for (int a = threadIdx.x; a < N2; a += kThreads) {
    mrow[a] = -INFINITY;
    lrow[a] = 0.f;
  }
  __syncthreads();
  normalize_rows<T>(an, N2, d, lda, 1.f);

  auto load_pixels = [&](int t0, int nt) {
    for (int r = threadIdx.x; r < nt; r += kThreads) {
      const int t = t0 + r;
      const int py = (sy * sh + t / sw + shift_h) % H, px = (sx * sw + t % sw + shift_w) % W;
      pix[r] = (b * H + py) * W + px;
    }
  };

  // pass A (a2w): k and v per tile, online softmax over N1 per anchor row
  for (int j = threadIdx.x; j < 2 * d; j += kThreads) cols[j] = (1 + j / d) * Cs + hh * d + j % d;
  for (int t0 = 0; t0 < N1; t0 += kTileRows) {
    const int nt = min(kTileRows, N1 - t0);
    load_pixels(t0, nt);
    __syncthreads();
    project_tile<T>(x, pix, nt, C, w, 3 * Cs, bqkv, cols, 2 * d, scratch, tile, ldt);
    normalize_rows<T>(tile, nt, d, ldt, scale1[hh]);
    for (int i = threadIdx.x; i < nt * d; i += kThreads) {
      float* v = tile + (i / d) * ldt + d + i % d;
      *v = round_mm<T>(*v);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N2 * nt; i += kThreads) {
      const int a = i / nt, t = i % nt;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(an[a * lda + e], tile[t * ldt + e], s);
      s += bias_a2w[((size_t)hh * N2 + a) * N1 + t0 + t];
      if (band && band_a[a] != band[t0 + t]) s += -100.f;
      scratch[a * lds + t] = s;
    }
    __syncthreads();
    for (int a = warp; a < N2; a += kWarps) {
      float* s = scratch + a * lds;
      float mt = -INFINITY;
      for (int t = lane; t < nt; t += 32) mt = fmaxf(mt, s[t]);
      const float m_old = mrow[a];
      const float m_new = fmaxf(m_old, warp_max(mt));
      const float corr = expf(m_old - m_new);
      float ls = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(s[t] - m_new);
        ls += e;
        s[t] = round_mm<T>(e);
      }
      ls = warp_sum(ls);
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float o = 0.f;
        for (int t = 0; t < nt; ++t) o = fmaf(s[t], tile[t * ldt + d + e], o);
        acc[a * lda + e] = fmaf(acc[a * lda + e], corr, o);
      }
      __syncwarp();
      if (lane == 0) {
        lrow[a] = fmaf(lrow[a], corr, ls);
        mrow[a] = m_new;
      }
    }
    __syncthreads();
  }
  // x1 = sums / row sum, rounded to T as the second product's operand
  for (int i = threadIdx.x; i < N2 * d; i += kThreads) {
    const int a = i / d, e = i % d;
    acc[a * lda + e] = round_mm<T>(acc[a * lda + e] * (1.f / lrow[a]));
  }

  // pass B (w2a): q per tile, softmax over N2 per token, times x1
  for (int j = threadIdx.x; j < d; j += kThreads) cols[j] = hh * d + j;
  for (int t0 = 0; t0 < N1; t0 += kTileRows) {
    const int nt = min(kTileRows, N1 - t0);
    __syncthreads();
    load_pixels(t0, nt);
    __syncthreads();
    project_tile<T>(x, pix, nt, C, w, 3 * Cs, bqkv, cols, d, scratch, tile, ldt);
    normalize_rows<T>(tile, nt, d, ldt, scale2[hh]);
    __syncthreads();
    float* p = scratch + warp * N2;
    for (int t = warp; t < nt; t += kWarps) {
      const float* qt = tile + t * ldt;
      const float* brow = bias_w2a + ((size_t)hh * N1 + t0 + t) * N2;
      const int bt = band ? band[t0 + t] : 0;
      float mx = -INFINITY;
      for (int a = lane; a < N2; a += 32) {
        float s = 0.f;
        for (int e = 0; e < d; ++e) s = fmaf(qt[e], an[a * lda + e], s);
        s += brow[a];
        if (band && band_a[a] != bt) s += -100.f;
        p[a] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int a = lane; a < N2; a += 32) {
        const float e = expf(p[a] - mx);
        sum += e;
        p[a] = round_mm<T>(e);
      }
      const float inv = 1.f / warp_sum(sum);
      __syncwarp();
      const int tt = t0 + t;
      T* out = y + ((size_t)(b * H + sy * sh + tt / sw) * W + sx * sw + tt % sw) * Cs + hh * d;
      for (int e = lane; e < d; e += 32) {
        float o = 0.f;
        for (int a = 0; a < N2; ++a) o = fmaf(p[a], acc[a * lda + e], o);
        out[e] = from_f<T>(o * inv);
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch_stripe_half(const void* x, const void* anchor, const void* w, const float* bqkv,
                       const float* s1, const float* s2, const float* b1, const float* b2,
                       const int* bands, const int* bands_a, void* y, int B, int H, int W,
                       int C, int Cs, int heads, int sh, int sw, int df, int shift_h,
                       int shift_w, cudaStream_t stream) {
  const int d = Cs / heads, N2 = (sh / df) * (sw / df);
  const size_t smem =
      sizeof(float) *
      (kTileRows + 2 * d + std::max(kProjScratch, std::max(N2 * (kTileRows + 1), kWarps * N2)) +
       kTileRows * (2 * d + 1) + 2 * N2 * (d + 1) + 2 * N2);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return -1;
  auto kernel = stripe_half_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * (H / sh) * (W / sw), heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(anchor), static_cast<const T*>(w),
      bqkv, s1, s2, b1, b2, bands, bands_a, static_cast<T*>(y), H, W, C, Cs, heads, sh, sw,
      df, shift_h, shift_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grlir

// Returns 0 on success, -1 when the stripe does not fit in shared memory, or
// the cudaError_t of a failed launch.
extern "C" int grlir_stripe_half(const void* x, const void* anchor, const void* w,
                                 const float* bqkv, const float* s1, const float* s2,
                                 const float* b1, const float* b2, const int* bands,
                                 const int* bands_a, void* y, int B, int H, int W, int C,
                                 int Cs, int heads, int sh, int sw, int df, int shift_h,
                                 int shift_w, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_stripe_half<__nv_bfloat16>(x, anchor, w, bqkv, s1, s2, b1, b2,
                                                    bands, bands_a, y, B, H, W, C, Cs, heads,
                                                    sh, sw, df, shift_h, shift_w, s);
  return grlir::launch_stripe_half<float>(x, anchor, w, bqkv, s1, s2, b1, b2, bands, bands_a,
                                          y, B, H, W, C, Cs, heads, sh, sw, df, shift_h,
                                          shift_w, s);
}
