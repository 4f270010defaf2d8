// Cosine attention of windows and stripes of up to 600 keys, all in fp32.
//
// Replaces three Pallas kernels of grlir/ops/pallas/attention.py, each a fused cosine
// attention on operands projected beforehand:
//   B6   `_qkv_attention_kernel` (:159-211, entry `fused_window_attention_qkv` :214):
//        windows of at most 256 tokens from channel-major qkv, shift mask from band ids;
//   B7a  `_attention_kernel` (:32-71, entry `fused_cosine_attention` :90): split q, k, v
//        (the stripe engine's a2w and w2a steps at most 256 tokens) with a dense mask;
//   B7b  `_packed_attention_kernel` (:308-360, entry `fused_cosine_attention_packed`
//        :363): P windows packed block-diagonally for the TPU's 128-wide matrix unit, -1e9
//        off the diagonal blocks.  exp(-1e9 - max) is 0 in fp32, so its function is B7a's;
//        its entry launches this same kernel.
// Numerics of all three: operands cast to fp32 whatever their type; q and k unit-normed as
// t * rsqrt(max(sum t^2, 1e-24)) and not rounded; fp32 logits, the logit scale applied
// after the product, then the fp32 bias and the mask; a normalised fp32 softmax; its
// product with v in fp32.  Only y is rounded, to the input type.
//
// One block per (window, head, 32 query rows).  The window's keys (unit-normed) and
// values stay resident in shared memory in fp32, zero-padded to 32 columns.  Each lane of
// a warp holds one query row in registers; for the logits and for the product with v the
// 8 warps take the keys in turn (one float4 broadcast from shared memory per 4 FMAs); one
// warp per row takes the softmax.  Operands are read through element strides (window,
// head, token, channel), so B6's channel-major qkv and the stripe engine's d-major views
// are read where they lie, without a copy.
//
// What bounds it on an H100: FMAs on CUDA cores.  The TPU kernels compute in fp32, so the
// work is fp32 (2 Nq Nk d FMAs a window and head against 67 TFLOP/s), not the bf16 tensor
// rate; the bytes are few (q, k, v and y once, the bias and mask from L2).  At Nk = 256 and
// d = 32 a whole window's logits (256 KB) would not fit a block's 227 KB, hence the 32-row
// tiles; each row tile of a window reads its keys and values again, from L2.
#include "large_attn.cuh"

namespace grlir {
namespace {

// Operands of cosine_attention_kernel.  q, k, v, y: (groups, heads, Nq|Nk, d) read and
// written through element strides s[operand][window, head, token, channel].  scale
// (heads,); bias (heads, Nq, Nk) fp32; mask (windows, Nq, Nk) fp32 or null; bands
// (windows, Nq) shift-band ids (Nq == Nk) or null; window g reads row g % windows.
struct CosArgs {
  const void* q;
  const void* k;
  const void* v;
  void* y;
  long long s[4][4];
  const float* scale;
  const float* bias;
  const float* mask;
  const int* bands;
  int groups, windows, heads, d, Nq, Nk;
};

// floats of shared memory: keys and values (reused for the cross-warp sum), then 32 rows
// of logits at an odd stride
__host__ __device__ inline int kv_floats(int Nk) {
  return 2 * Nk * kDP > kWarps * kDP * kRows ? 2 * Nk * kDP : kWarps * kDP * kRows;
}
__host__ __device__ inline int logit_ld(int Nk) { return Nk | 1; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
cosine_attention_kernel(CosArgs a) {
  extern __shared__ float smem[];
  const int Nk = a.Nk, d = a.d, ld = logit_ld(Nk);
  float* ks = smem;                   // [Nk][kDP] unit-normed keys
  float* vs = ks + Nk * kDP;          // [Nk][kDP] values
  float* sc = smem + kv_floats(Nk);   // [kRows][ld] logits, then probabilities
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gh = blockIdx.y, g = gh / a.heads, hh = gh % a.heads;
  const int row0 = blockIdx.x * kRows;
  const long long* sq = a.s[0];
  const long long* sk = a.s[1];
  const long long* sv = a.s[2];
  const long long* sy = a.s[3];
  const T* qp = static_cast<const T*>(a.q) + g * sq[0] + hh * sq[1];
  const T* kp = static_cast<const T*>(a.k) + g * sk[0] + hh * sk[1];
  const T* vp = static_cast<const T*>(a.v) + g * sv[0] + hh * sv[1];

  // 1. keys and values to shared memory (tokens fastest when they are contiguous)
  const bool tok_fast = sk[2] == 1;
  for (int i = threadIdx.x; i < Nk * kDP; i += kThreads) {
    const int t = tok_fast ? i % Nk : i / kDP, e = tok_fast ? i / Nk : i % kDP;
    const bool in = e < d;
    ks[t * kDP + e] = in ? to_f(kp[t * sk[2] + e * sk[3]]) : 0.f;
    vs[t * kDP + e] = in ? to_f(vp[t * sv[2] + e * sv[3]]) : 0.f;
  }
  // this lane's query row, unit-normed in registers
  const int r = row0 + lane;
  float q[kDP], acc[kDP];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < kDP; ++e) {
    q[e] = (r < a.Nq && e < d) ? to_f(qp[r * sq[2] + e * sq[3]]) : 0.f;
    ss = fmaf(q[e], q[e], ss);
    acc[e] = 0.f;
  }
  const float qinv = rsqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int e = 0; e < kDP; ++e) q[e] *= qinv;
  __syncthreads();
  // 2. unit-norm the keys: one warp per key, one lane per channel
  for (int t = warp; t < Nk; t += kWarps) {
    const float x = ks[t * kDP + lane];
    ks[t * kDP + lane] = x * rsqrtf(fmaxf(warp_sum(x * x), 1e-24f));
  }
  __syncthreads();

  // 3. logits: lane = query row, warps take the keys in turn
  for (int t = warp; t < Nk; t += kWarps) {
    const float4* k4 = reinterpret_cast<const float4*>(ks + t * kDP);
    float s = 0.f;
#pragma unroll
    for (int e4 = 0; e4 < kDP / 4; ++e4) {
      const float4 kv = k4[e4];
      s = fmaf(q[4 * e4], kv.x, s);
      s = fmaf(q[4 * e4 + 1], kv.y, s);
      s = fmaf(q[4 * e4 + 2], kv.z, s);
      s = fmaf(q[4 * e4 + 3], kv.w, s);
    }
    sc[lane * ld + t] = s;
  }
  __syncthreads();

  // 4. scale, bias, mask and a normalised softmax, one warp per row
  const float scale = a.scale[hh];
  const int win = g % a.windows;
  const int* band = a.bands ? a.bands + (size_t)win * Nk : nullptr;
  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int row = row0 + rr;
    if (row >= a.Nq) continue;
    float* srow = sc + rr * ld;
    const float* brow = a.bias + ((size_t)hh * a.Nq + row) * Nk;
    const float* mrow = a.mask ? a.mask + ((size_t)win * a.Nq + row) * Nk : nullptr;
    const int bq = band ? band[row] : 0;
    float mx = -INFINITY;
    for (int t = lane; t < Nk; t += 32) {
      float x = __fadd_rn(__fmul_rn(srow[t], scale), brow[t]);
      if (mrow) x = __fadd_rn(x, mrow[t]);
      if (band && band[t] != bq) x = __fadd_rn(x, -100.f);
      srow[t] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < Nk; t += 32) {
      const float e = expf(srow[t] - mx);
      srow[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < Nk; t += 32) srow[t] = __fdiv_rn(srow[t], sum);
  }
  __syncthreads();

  // 5. probabilities times v: lane = query row, warps take the keys in turn
  for (int t = warp; t < Nk; t += kWarps) {
    const float p = sc[lane * ld + t];
    const float4* v4 = reinterpret_cast<const float4*>(vs + t * kDP);
#pragma unroll
    for (int e4 = 0; e4 < kDP / 4; ++e4) {
      const float4 vv = v4[e4];
      acc[4 * e4] = fmaf(p, vv.x, acc[4 * e4]);
      acc[4 * e4 + 1] = fmaf(p, vv.y, acc[4 * e4 + 1]);
      acc[4 * e4 + 2] = fmaf(p, vv.z, acc[4 * e4 + 2]);
      acc[4 * e4 + 3] = fmaf(p, vv.w, acc[4 * e4 + 3]);
    }
  }
  __syncthreads();
  // sum the warps' partial products (red[warp][e][row]) and write y
  float* red = smem;
#pragma unroll
  for (int e = 0; e < kDP; ++e) red[(warp * kDP + e) * kRows + lane] = acc[e];
  __syncthreads();
  T* yp = static_cast<T*>(a.y) + g * sy[0] + hh * sy[1];
  const bool y_tok_fast = sy[2] == 1;
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int rr = y_tok_fast ? i % kRows : i / d, e = y_tok_fast ? i / kRows : i % d;
    const int row = row0 + rr;
    if (row >= a.Nq) continue;
    float y = 0.f;
    for (int w = 0; w < kWarps; ++w) y += red[(w * kDP + e) * kRows + rr];
    yp[row * sy[2] + e * sy[3]] = from_f<T>(y);
  }
}

// Launch cosine_attention_kernel; returns 0, -1 (d > 32 or shared memory) or a
// cudaError_t.
template <typename T>
int launch_cosine(const CosArgs& a, cudaStream_t stream) {
  if (a.d > kDP) return -1;
  auto kernel = cosine_attention_kernel<T>;
  const size_t smem = sizeof(float) * (kv_floats(a.Nk) + (size_t)kRows * logit_ld(a.Nk));
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((a.Nq + kRows - 1) / kRows, a.groups * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int run_cosine(const void* q, const void* k, const void* v, void* y, const long long* st,
               const float* scale, const float* bias, const float* mask, const int* bands,
               int groups, int windows, int heads, int d, int Nq, int Nk, int is_bf16,
               void* stream) {
  CosArgs a{q, k, v, y, {}, scale, bias, mask, bands, groups, windows, heads, d, Nq, Nk};
  for (int i = 0; i < 16; ++i) a.s[i / 4][i % 4] = st[i];
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_cosine<__nv_bfloat16>(a, s) : launch_cosine<float>(a, s);
}

}  // namespace
}  // namespace grlir

// The three C entries share one argument list.  q, k, v, y: (groups, heads, Nq|Nk, d)
// operands in x's type, then their element strides (window, head, token, channel): q's
// four, then k's, v's and y's; scale (heads,) fp32; bias (heads, Nq, Nk) fp32; mask
// (windows, Nq, Nk) fp32 or null; bands (windows, Nq) int32 or null.  Each returns 0, -1
// (d > 32 or more keys than shared memory holds) or a cudaError_t.
#define GRLIR_COSINE_ENTRY(name)                                                          \
  extern "C" int name(const void* q, const void* k, const void* v, void* y,              \
                      long long q0, long long q1, long long q2, long long q3, long long k0, \
                      long long k1, long long k2, long long k3, long long v0, long long v1, \
                      long long v2, long long v3, long long y0, long long y1, long long y2, \
                      long long y3, const float* scale, const float* bias,                \
                      const float* mask, const int* bands, int groups, int windows,      \
                      int heads, int d, int Nq, int Nk, int is_bf16, void* stream) {     \
    const long long st[16] = {q0, q1, q2, q3, k0, k1, k2, k3,                             \
                              v0, v1, v2, v3, y0, y1, y2, y3};                            \
    return grlir::run_cosine(q, k, v, y, st, scale, bias, mask, bands, groups, windows,  \
                             heads, d, Nq, Nk, is_bf16, stream);                          \
  }

// B6: channel-major qkv windows, band-id mask
GRLIR_COSINE_ENTRY(grlir_window_attention_qkv)
// B7a: split q, k, v, dense mask
GRLIR_COSINE_ENTRY(grlir_cosine_attention_split)
// B7b: the packed windows of B7a, one window at a time
GRLIR_COSINE_ENTRY(grlir_cosine_attention_packed)
