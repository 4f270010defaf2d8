// Cosine attention for large windows and stripes on q, k, v projected
// beforehand, channel-major (B, nW, h, d, N).
//
// Replaces the Pallas kernel `_flash_kernel` (grlir/ops/pallas/flash_attention.py:32-80,
// entry `flash_rect_attention` :83-165), which the fused attention engines run on windows
// and stripes of more than 256 tokens: GRL-S's 8x64 stripes at 256^2 (a2w N1 = 32 queries
// against 512 keys, w2a 512 against 32) and GRL-base's 32x32 windows (N = 1024) and 64x64
// stripes at anchor df 2 (1024 anchors, 4096 stripe tokens).  Its rounding is B4's: q and
// k unit-normed in fp32 and rounded to the input type, the logit scale applied after the
// product, the bias read in the input type (bf16) or fp32, the softmax's probabilities
// rounded to the input type (normalised first on the TPU and the CUDA-core route; the
// tensor-core route scales the product by 1/sum after it), every product summed in fp32.
//
// Two kernels on one stream:
//   flash_rows_kernel   one launch for q, k and v: a block takes 64 tokens of one (window,
//                       head) slice of one of them, reads its d x 64 channel-major values
//                       with neighbouring threads on neighbouring tokens, transposes them
//                       through shared memory, unit-norms q and k in fp32 (no scale: it
//                       comes after the product) and writes token-major rows rounded to
//                       the input type: for bf16 rows of head_cols(d) = 32 or 64 columns,
//                       zeros past d, in 16-byte stores (the rows mma_attend_kernel reads
//                       through ldmatrix); for fp32 rows of d;
//   bf16: mma_attend_kernel (mma_attend.cuh, B3's and B4's tensor-core attention)
//                       one block per (window, head, 64 or 128 query rows), keys and values
//                       streamed in chunks of 64 through shared memory, the bf16 bias read
//                       into registers, q k^T and p v on mma.sync with fp32 accumulators,
//                       one pass (an online softmax), y written channel-major;
//   fp32: attend_kernel (large_attn.cuh) on CUDA cores, one lane per query row: TF32
//                       products would not hold fp32.
//
// What bounds it on an H100: the operations, 4 N1 N2 d a window and head (logits and the
// product with v) at the bf16 tensor-core rate, against the bytes of q, k, v, the bias and
// y once.  A block's 64 or 128 rows share each key chunk; the bias tile of a (head, row
// tile) is read by the blocks of every window in flight at once (the window is the grid's
// fastest index), so it comes from HBM about once.
#include <type_traits>

#include "mma_attend.cuh"

namespace grlir {
namespace {

constexpr int kRowTokens = 64;  // tokens a block of flash_rows_kernel

// Rows of q, k and v: block (gh, t) of the grid takes tokens 64 t' .. 64 t' + 63 of slice
// gh of q (t < tq, t' = t), k (tq <= t < tq + tk) or v (the rest).  src (d, N)
// channel-major -> dst[gh][n][0..ld), times rsqrt(max(sum_e src^2, 1e-24)) summed in fp32
// for q and k, rounded to T; zeros from d to ld.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ ws_q, T* __restrict__ ws_k, T* __restrict__ ws_v, int d,
                  int ld, int N1, int N2) {
  __shared__ float tile[kRowTokens][kMaxD + 1];  // [token][channel]: conflict-free both ways
  __shared__ float inv[kRowTokens];
  const int tq = (N1 + kRowTokens - 1) / kRowTokens, tk = (N2 + kRowTokens - 1) / kRowTokens;
  const int gh = blockIdx.x, tid = threadIdx.x;
  int t = blockIdx.y;
  const int part = t < tq ? 0 : t < tq + tk ? 1 : 2;
  t -= part == 0 ? 0 : part == 1 ? tq : tq + tk;
  const int N = part ? N2 : N1, n0 = t * kRowTokens, nt = min(kRowTokens, N - n0);
  const T* src = (part == 0 ? q : part == 1 ? k : v) + (size_t)gh * d * N + n0;
  T* dst = (part == 0 ? ws_q : part == 1 ? ws_k : ws_v) + ((size_t)gh * N + n0) * ld;

  for (int i = tid; i < d * kRowTokens; i += kThreads) {
    const int e = i / kRowTokens, n = i % kRowTokens;
    tile[n][e] = n < nt ? to_f(src[(size_t)e * N + n]) : 0.f;
  }
  __syncthreads();
  if (tid < kRowTokens) {
    float ss = 0.f;
    for (int e = 0; e < d; ++e) ss = fmaf(tile[tid][e], tile[tid][e], ss);
    inv[tid] = part < 2 ? rsqrtf(fmaxf(ss, 1e-24f)) : 1.f;
  }
  __syncthreads();
  // the tile's nt rows of ld values are contiguous in dst
  if constexpr (std::is_same<T, bf16>::value) {
    for (int i = tid; i < nt * (ld / 8); i += kThreads) {
      const int r = i / (ld / 8), c = (i % (ld / 8)) * 8;
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = c + 2 * j;
        w[j] = pack_bf16(e < d ? tile[r][e] * inv[r] : 0.f,
                         e + 1 < d ? tile[r][e + 1] * inv[r] : 0.f);
      }
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int i = tid; i < nt * ld; i += kThreads) {
      const int r = i / ld, e = i % ld;
      dst[i] = from_f<T>(e < d ? tile[r][e] * inv[r] : 0.f);
    }
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, const float* scale,
                 const void* bias, const int* bands_q, const int* bands_k, void* ws_q,
                 void* ws_kv, void* y, int groups, int windows, int heads, int d, int N1,
                 int N2, cudaStream_t stream) {
  constexpr bool kTensorCores = std::is_same<T, bf16>::value;
  if (d > kMaxD) return -1;
  const int gh = groups * heads, ld = kTensorCores ? head_cols(d) : d;
  const long long tiles = 2LL * ((N2 + kRowTokens - 1) / kRowTokens) +
                          (N1 + kRowTokens - 1) / kRowTokens;
  if (tiles > 65535) return -1;
  T* wk = static_cast<T*>(ws_kv);
  T* wv = wk + (size_t)gh * N2 * ld;
  flash_rows_kernel<T><<<dim3(gh, static_cast<unsigned>(tiles)), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(ws_q), wk, wv, d, ld, N1, N2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  AttnArgs a{};
  a.q = ws_q;
  a.k = wk;
  a.v = wv;
  a.q_stride = (long long)N1 * ld;
  a.k_stride = a.v_stride = (long long)N2 * ld;
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
  if constexpr (kTensorCores)
    return launch_mma_attend(a, groups, stream);
  else
    return launch_attend<float, float, false>(a, groups, stream);
}

}  // namespace
}  // namespace grlir

// q (groups, heads, d, N1), k and v (groups, heads, d, N2) in x's type, channel-major;
// scale (heads,) fp32; bias (heads, N1, N2) in x's type; bands_q (windows, N1) and
// bands_k (windows, N2) int32, or both null (window g of the batch reads row g % windows);
// ws_q: groups * heads * N1 * ld and ws_kv: 2 * groups * heads * N2 * ld elements of x's
// type, ld = head_cols(d) (32 or 64) for bf16, d for fp32; y (groups, heads, d, N1) out.
// bf16 runs on tensor cores, fp32 on CUDA cores.  Returns 0, -1 (d > 64, shared memory,
// or more than 65535 token tiles) or a cudaError_t.
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
