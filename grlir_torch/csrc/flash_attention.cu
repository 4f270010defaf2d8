// Cosine attention for large windows and stripes on q, k, v projected
// beforehand, channel-major (B, nW, h, d, N).
//
// Replaces the Pallas kernel `_flash_kernel` (grlir/ops/pallas/flash_attention.py:32-80,
// entry `flash_rect_attention` :83-165), which the fused attention engines run on windows
// and stripes of more than 256 tokens: GRL-S's 8x64 stripes at 256^2 (a2w N1 = 32 queries
// against 512 keys, w2a 512 against 32) and GRL-base's 32x32 windows (N = 1024) and 64x64
// stripes at anchor df 2 (1024 anchors, 4096 stripe tokens).  Its rounding is B4's: q and
// k unit-normed in fp32 and rounded to the input type, the logit scale applied after the
// product, the bias read in the input type (bf16) or fp32, the softmax normalised before
// its probabilities are rounded to the input type, every product summed in fp32.
//
// Two kernels on one stream:
//   tokens_major_kernel  (window, head) slices of d x N channel-major -> N x d token-major,
//                        unit-normed for q and k, rounded to T: one thread per token, so
//                        neighbouring threads read neighbouring addresses;
//   attend_kernel        (large_attn.cuh, shared with B3/B4) one block per (window, head,
//                        32 query rows), keys and values streamed through shared memory in
//                        chunks of 128 in two passes (max and sum, then probabilities
//                        times v), y written channel-major.
//
// What bounds it on an H100: as for B3/B4, fp32 FMAs on CUDA cores, 2 N1 N2 d for the
// logits (twice: one pass for max and sum, one for the probabilities) and N1 N2 d for the
// product with v, a window and head, on operands rounded to the input type.  The bias
// (h, N1, N2) is read once per row tile and the token-major q/k/v workspace, written once,
// stays in L2 at the main path's sizes.  Tensor cores (mma/wgmma) are later work.
#include "large_attn.cuh"

namespace grlir {
namespace {

// dst[gh][n][e] = src[gh][e][n] (e < d), times rsqrt(max(sum_e src^2, 1e-24)) summed in
// fp32 when norm is set, rounded to T.  Grid (ceil(N / kThreads), groups * heads).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tokens_major_kernel(const T* __restrict__ src, T* __restrict__ dst, int d, int N, int norm) {
  const int gh = blockIdx.y, n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T* s = src + (size_t)gh * d * N + n;
  float v[kMaxD];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    v[e] = e < d ? to_f(s[(size_t)e * N]) : 0.f;
    ss = fmaf(v[e], v[e], ss);
  }
  const float inv = norm ? rsqrtf(fmaxf(ss, 1e-24f)) : 1.f;
  T* o = dst + ((size_t)gh * N + n) * d;
#pragma unroll
  for (int e = 0; e < kMaxD; ++e)
    if (e < d) o[e] = from_f<T>(v[e] * inv);
}

template <typename T>
int launch_tokens_major(const void* src, void* dst, int gh, int d, int N, int norm,
                        cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, gh);
  tokens_major_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(src),
                                                         static_cast<T*>(dst), d, N, norm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, const float* scale,
                 const void* bias, const int* bands_q, const int* bands_k, void* ws_q,
                 void* ws_kv, void* y, int groups, int windows, int heads, int d, int N1,
                 int N2, cudaStream_t stream) {
  if (d > kMaxD) return -1;
  const int gh = groups * heads;
  T* wk = static_cast<T*>(ws_kv);
  T* wv = wk + (size_t)gh * N2 * d;
  int err = launch_tokens_major<T>(q, ws_q, gh, d, N1, 1, stream);
  if (!err) err = launch_tokens_major<T>(k, wk, gh, d, N2, 1, stream);
  if (!err) err = launch_tokens_major<T>(v, wv, gh, d, N2, 0, stream);
  if (err) return err;
  AttnArgs a{};
  a.q = ws_q;
  a.k = wk;
  a.v = wv;
  a.q_stride = (long long)N1 * d;
  a.k_stride = a.v_stride = (long long)N2 * d;
  a.Nq = N1;
  a.Nk = N2;
  a.d = d;
  a.heads = heads;
  a.regions = windows;
  a.scale = scale;
  a.bias = bias;
  a.band_q = bands_q;
  a.band_k = bands_k;
  a.out = y;
  a.out_cm = 1;
  return launch_attend<T, T, false>(a, groups, stream);
}

}  // namespace
}  // namespace grlir

// q (groups, heads, d, N1), k and v (groups, heads, d, N2) in x's type, channel-major;
// scale (heads,) fp32; bias (heads, N1, N2) in x's type; bands_q (windows, N1) and
// bands_k (windows, N2) int32, or both null (window g of the batch reads row g % windows);
// ws_q: groups * heads * N1 * d and ws_kv: 2 * groups * heads * N2 * d elements of x's
// type; y (groups, heads, d, N1) out.  Returns 0, -1 (d > 64 or shared memory) or a
// cudaError_t.
extern "C" int grlir_flash_rect_attention(const void* q, const void* k, const void* v,
                                          const float* scale, const void* bias,
                                          const int* bands_q, const int* bands_k, void* ws_q,
                                          void* ws_kv, void* y, int groups, int windows,
                                          int heads, int d, int N1, int N2, int is_bf16,
                                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_flash<__nv_bfloat16>(q, k, v, scale, bias, bands_q, bands_k, ws_q,
                                              ws_kv, y, groups, windows, heads, d, N1, N2, s);
  return grlir::launch_flash<float>(q, k, v, scale, bias, bands_q, bands_k, ws_q, ws_kv, y,
                                    groups, windows, heads, d, N1, N2, s);
}
