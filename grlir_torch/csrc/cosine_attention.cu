// Cosine attention of windows and stripes in fp32, on tensor cores.
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
// One block of 4 warps per (window, head, 64 query rows), 16 rows a warp, on tensor cores
// with fp32 accuracy ("3xTF32", the split of CUTLASS's fast fp32 GEMMs): every operand x of
// a product is split into TF32 halves, big = tf32(x) and small = tf32(x - big), and each
// product runs as three mma.sync.m16n8k8 TF32 products, a_big b_small + a_small b_big +
// a_big b_big, summed in fp32 (about 21 of fp32's 24 bits; one TF32 product alone keeps 11,
// a visible change of the probabilities at a logit scale of 100).  The block's q rows are
// unit-normed once in fp32 and split into A fragments held in registers.  Keys and values
// stream through shared memory in chunks of 64: each chunk's keys are unit-normed and
// split, its values split, once per block.  Pass 1 folds each row's max and sum over the
// chunks (exp as 2^x on the special-function unit, log2 e folded into one FMA); pass 2
// recomputes the logits with the same sequence (bit-equal) and forms the normalised
// probabilities p = exp(s - max) * (1 / sum) in registers, where the accumulator
// layout of q k^T serves as the A fragments of p v without a shuffle: key 2c of an 8-key
// tile takes the product's column c and key 2c + 1 column c + 4, and v's rows are read in
// that order.  One chunk (N <= 64, B6's and B7b's windows) is one pass: its logits stay in
// registers.  Operands are read through element strides (window, head, token, channel),
// so B6's channel-major qkv and the stripe engine's d-major views are read where they lie,
// without a copy.  Head dims up to 64 (32 or 64 columns in shared memory, zeros past d);
// any number of keys.
//
// What bounds it on an H100: the operations at B6's GRL-S windows (2 Nq Nk d multiply-adds
// for the logits and as many for p v, a window and head): 1.07 GFLOP a call, 0.016 ms at
// fp32's 67 TFLOP/s, 0.0065 ms as three TF32 products at 495 TFLOP/s; the bytes (q, k, v
// and y once, the bias and mask from L2) come next.
#include "large_attn.cuh"
#include "mma_util.cuh"

namespace grlir {
namespace {

// Operands of cosine_tf32_kernel.  q, k, v, y: (groups, heads, Nq|Nk, d) read and
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

constexpr int kCosThreads = 128;  // 4 warps
constexpr int kCosRows = 64;      // query rows a block: 16 a warp
constexpr int kCosKeys = 64;      // keys a chunk

// floats of shared memory: q rows, then the big and small halves of a chunk's keys and
// values, then the chunk's key band ids; rows of DP + 4 (the fragment reads of a quad
// land on distinct banks)
template <int DP>
constexpr int cos_smem_floats() {
  return (kCosRows + 4 * kCosKeys) * (DP + 4) + kCosKeys;
}

// rows t0..t0+63 of an operand (element strides st) into dst (rows of DP + 4), zeros past
// n rows and past d columns; tokens fastest when they are contiguous in memory
template <typename T, int DP>
__device__ void load_rows(float* dst, const T* src, const long long* st, int t0, int n,
                          int d) {
  constexpr int ld = DP + 4;
  const int tid = threadIdx.x;
  if (st[2] == 1) {  // a thread keeps its token, its channels step by kCosThreads / 64
    const int t = tid % 64;
    const bool in = t0 + t < n;
    const T* p = src + (t0 + t);
#pragma unroll
    for (int e = tid / 64; e < DP; e += kCosThreads / 64)
      dst[t * ld + e] = in && e < d ? to_f(p[e * st[3]]) : 0.f;
  } else {  // a thread keeps its channel, its tokens step by kCosThreads / DP
    const int e = tid % DP;
    const bool in = e < d;
    const T* p = src + e * st[3];
#pragma unroll
    for (int t = tid / DP; t < 64; t += kCosThreads / DP)
      dst[t * ld + e] = in && t0 + t < n ? to_f(p[(t0 + t) * st[2]]) : 0.f;
  }
}

// unit-norm the 64 rows of raw (rows of DP + 4) as t * rsqrt(max(sum t^2, 1e-24)), one warp
// a row; into raw itself (big null) or split into big and small (small may be raw)
template <int DP>
__device__ void norm_rows(float* raw, unsigned* big, unsigned* small) {
  constexpr int ld = DP + 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < 64; r += kCosThreads / 32) {
    float x[DP / 32];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      x[i] = raw[r * ld + lane + 32 * i];
      ss = fmaf(x[i], x[i], ss);
    }
    const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      const int at = r * ld + lane + 32 * i;
      if (big) {
        split_tf32(x[i] * inv, big[at], small[at]);
      } else {
        raw[at] = x[i] * inv;
      }
    }
  }
}

// split each value of the 64 rows of raw (rows of DP + 4) into big and small (small may be
// raw)
template <int DP>
__device__ void split_rows(const float* raw, unsigned* big, unsigned* small) {
  constexpr int ld = DP + 4;
  for (int i = threadIdx.x; i < 64 * DP; i += kCosThreads) {
    const int at = (i / DP) * ld + i % DP;
    split_tf32(raw[at], big[at], small[at]);
  }
}

// Cosine attention of 64 query rows of one (window, head); see the note at the top.
// Grid (groups * heads, ceil(Nq / 64)).
template <typename T, int DP>
__global__ void __launch_bounds__(kCosThreads)
cosine_tf32_kernel(CosArgs a) {
  constexpr int ld = DP + 4, KS = DP / 8;  // k-steps of q k^T = column tiles of p v
  extern __shared__ __align__(16) float cs[];
  float* qs = cs;                                                  // [64][ld] q rows
  unsigned* kb = reinterpret_cast<unsigned*>(qs + kCosRows * ld);  // [64][ld] keys, big
  unsigned* ksm = kb + kCosKeys * ld;                              // [64][ld] keys, small
  unsigned* vb = ksm + kCosKeys * ld;                              // [64][ld] values, big
  unsigned* vsm = vb + kCosKeys * ld;                              // [64][ld] values, small
  int* bks = reinterpret_cast<int*>(vsm + kCosKeys * ld);          // [64] key band ids
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gr = lane / 4, qd = lane % 4;
  const int gh = blockIdx.x, g = gh / a.heads, hh = gh % a.heads, row0 = blockIdx.y * kCosRows;
  const int Nq = a.Nq, Nk = a.Nk, d = a.d, win = g % a.windows;
  const long long* sq = a.s[0];
  const long long* sk = a.s[1];
  const long long* sv = a.s[2];
  const long long* sy = a.s[3];
  const T* qp = static_cast<const T*>(a.q) + g * sq[0] + hh * sq[1];
  const T* kp = static_cast<const T*>(a.k) + g * sk[0] + hh * sk[1];
  const T* vp = static_cast<const T*>(a.v) + g * sv[0] + hh * sv[1];
  const int* band = a.bands ? a.bands + (size_t)win * Nk : nullptr;
  const int nch = (Nk + kCosKeys - 1) / kCosKeys;

  // chunk c of the keys (unit-normed, split), with its values (split) when with_v
  auto load_chunk = [&](int c, bool with_v) {
    __syncthreads();  // the previous chunk is consumed
    load_rows<T, DP>(reinterpret_cast<float*>(ksm), kp, sk, c * kCosKeys, Nk, d);
    if (with_v) load_rows<T, DP>(reinterpret_cast<float*>(vsm), vp, sv, c * kCosKeys, Nk, d);
    if (band && tid < kCosKeys) bks[tid] = c * kCosKeys + tid < Nk ? band[c * kCosKeys + tid] : 0;
    __syncthreads();
    norm_rows<DP>(reinterpret_cast<float*>(ksm), kb, ksm);
    if (with_v) split_rows<DP>(reinterpret_cast<const float*>(vsm), vb, vsm);
    __syncthreads();
  };

  // this block's q rows, unit-normed in fp32, and the warp's A fragments of them
  load_rows<T, DP>(qs, qp, sq, row0, Nq, d);
  __syncthreads();
  norm_rows<DP>(qs, nullptr, nullptr);
  load_chunk(0, true);
  const int r0 = warp * 16 + gr;
  unsigned qa_big[KS][4], qa_small[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = kk * 8 + qd;
    split_tf32(qs[r0 * ld + col], qa_big[kk][0], qa_small[kk][0]);
    split_tf32(qs[(r0 + 8) * ld + col], qa_big[kk][1], qa_small[kk][1]);
    split_tf32(qs[r0 * ld + col + 4], qa_big[kk][2], qa_small[kk][2]);
    split_tf32(qs[(r0 + 8) * ld + col + 4], qa_big[kk][3], qa_small[kk][3]);
  }
  const int rows[2] = {row0 + r0, row0 + r0 + 8};
  const int bq[2] = {band && rows[0] < Nq ? band[rows[0]] : 0,
                     band && rows[1] < Nq ? band[rows[1]] : 0};
  const float scale = a.scale[hh];

  // s[j][e]: row rows[e / 2], key c * 64 + 8 j + 2 qd + e % 2 of chunk c: the fp32 product,
  // times the scale, plus the bias, the mask or the band mask; -inf past Nk
  float s[8][4];
  auto logits = [&](int c) {
    // the bias and mask values of the thread's 32 logits, every load issued
    // before the products, so that their trips to L2 overlap them
    float bv[8][4], mv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], key = c * kCosKeys + j * 8 + 2 * qd + (e & 1);
        const bool in = key < Nk && row < Nq;
        bv[j][e] = in ? __ldg(a.bias + ((size_t)hh * Nq + row) * Nk + key) : 0.f;
        mv[j][e] = in && a.mask ? __ldg(a.mask + ((size_t)win * Nq + row) * Nk + key) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (j * 8 + gr) * ld + kk * 8 + qd;
        mma_3xtf32(s[j], qa_big[kk], qa_small[kk], kb[at], kb[at + 4], ksm[at], ksm[at + 4]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], kc = j * 8 + 2 * qd + (e & 1);
        float x = -INFINITY;
        if (c * kCosKeys + kc < Nk && row < Nq) {
          x = __fadd_rn(__fmul_rn(s[j][e], scale), bv[j][e]);
          if (a.mask) x = __fadd_rn(x, mv[j][e]);
          if (band && bks[kc] != bq[e >> 1]) x = __fadd_rn(x, -100.f);
        }
        s[j][e] = x;
      }
  };

  // pass 1: each row's max and sum over all keys (this thread's keys, then its quad's).
  // One chunk: the row's max first, then e = exp(s - max) kept in s for pass 2.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    if (c > 0) load_chunk(c, false);
    logits(c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      if (nch == 1) mx = quad_max(mx);
      const float m_new = fmaxf(m[r], mx);
      if (m_new == -INFINITY) continue;
      const float ml = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = ex2(fmaf(s[j][2 * r + e], kLog2e, -ml));
          if (nch == 1) s[j][2 * r + e] = ex;
          sum += ex;
        }
      l[r] = fmaf(l[r], ex2((m[r] - m_new) * kLog2e), sum);
      m[r] = m_new;
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mq = quad_max(m[r]);
    inv_l[r] = 1.f / quad_sum(m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mq) * kLog2e));
    m[r] = mq * kLog2e;
  }

  // pass 2: p = exp(s - max) / sum, then p v in 3xTF32
  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (nch > 1) {
      load_chunk(c, true);
      logits(c);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // A fragment of p for the keys of tile j: rows r0 (a0, a2) and r0 + 8 (a1, a3),
      // keys 2 qd (a0, a1) and 2 qd + 1 (a2, a3)
      unsigned pb[4], ps[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ex = nch == 1 ? s[j][e] : ex2(fmaf(s[j][e], kLog2e, -m[r]));
        split_tf32(ex * inv_l[r], pb[(e & 1) * 2 + r], ps[(e & 1) * 2 + r]);
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int at0 = (j * 8 + 2 * qd) * ld + n * 8 + gr, at1 = at0 + ld;
        mma_3xtf32(o[n], pb, ps, vb[at0], vb[at1], vsm[at0], vsm[at1]);
      }
    }
  }

  // y in the caller's layout, rounded to T
  T* yp = static_cast<T*>(a.y) + g * sy[0] + hh * sy[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Nq) continue;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * qd + e;
        if (col < d) yp[rows[r] * sy[2] + col * sy[3]] = from_f<T>(o[n][2 * r + e]);
      }
  }
}

// Launch cosine_tf32_kernel; returns 0, -1 (d > 64 or shared memory) or a cudaError_t.
template <typename T, int DP>
int launch_cosine_dp(const CosArgs& a, cudaStream_t stream) {
  auto kernel = cosine_tf32_kernel<T, DP>;
  const size_t smem = sizeof(float) * cos_smem_floats<DP>();
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(a.groups * a.heads, (a.Nq + kCosRows - 1) / kCosRows);
  kernel<<<grid, kCosThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cosine(const CosArgs& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_cosine_dp<T, 32>(a, stream);
  if (a.d <= 64) return launch_cosine_dp<T, 64>(a, stream);
  return -1;
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
// (d > 64) or a cudaError_t.
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
