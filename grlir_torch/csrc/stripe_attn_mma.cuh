// Tensor-core building blocks of the bf16 routes of the large-window half
// (B3, window_half_large.cu), the resident-bias stripe half (B2,
// stripe_half.cu), the streamed-bias stripe half (B4, stripe_half_large.cu)
// and the rectangular flash attention (B5, flash_attention.cu): a
// projection, the two-pass softmax helpers of B1's and B2's own kernels,
// and (mma_attend.cuh) the one-pass attention of B3, B4 and B5, all on
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators), the products the
// TPU kernels compute on their matrix unit with
// dot_general(..., preferred_element_type=f32).  The fp32 routes keep the
// CUDA-core kernels (TF32 products would not hold fp32).
//
//   mma_project_kernel  64 tokens of a region a block, gathered through
//                       Regions::pixel (the cyclic shift), times w (its
//                       transpose in bf16, rows 16-byte aligned, each head
//                       zero-padded to DP columns in shared memory) on
//                       tensor cores; fp32 bias, per-head unit norm, then a
//                       per-part, per-head scale where the TPU folds the
//                       logit scale into q or k before rounding (B2, B3);
//                       bf16 rows of DP = 32 or 64 (`head_cols`, zeros
//                       past d) into a workspace [region][head][part]
//                       [token][DP];
//   pad_rows_kernel     rows of d values -> rows of DP (B4b's x1);
//   mma_attend_kernel   (mma_attend.cuh) softmax(q k^T scale + bias + mask) v
//                       for 64 or 128 query rows of one (region, head) a
//                       block, 16 rows a warp, in one pass over the keys.
//                       It replaces the TPU kernels `_window_block_kernel`'s
//                       q-tiled branch (grlir/ops/pallas/block_attn.py:311,
//                       B3), `_stripe_a2w_large_kernel` (:1037, B4a),
//                       `_stripe_w2a_large_kernel` (:1104, B4b) and
//                       `_flash_kernel` (grlir/ops/pallas/flash_attention.py:32,
//                       B5), each after its own projection or prologue.
//
// mma_attend_kernel's design.  Keys and values stream through shared
// memory in chunks of 64 keys, two stages filled with cp.async (one chunk
// computed, the next in flight), into fragments with ldmatrix (.trans for
// v).  The keys of a chunk sit in the logits' accumulators in an order
// (`mma_key`) that gives each thread 16 consecutive keys of its rows, so it
// reads its bias values straight from L2 into registers, 32 contiguous bytes
// a row, one chunk ahead; k and v rows are stored in that order, so their
// fragments load as before.  For each chunk a warp computes its 16 rows'
// logits once, raises each row's running max (quad shuffles), rescales o
// and l by 2^((m_old - m_new) log2 e) when the max rose in any row of the
// warp, forms p = bf16(2^(s log2 e - m log2 e)) in registers as the A
// fragments of P v, adds the unrounded p into l and accumulates o += p v in
// fp32; y = o / l at the end.  Rows a block: 128 (8 warps) where the grid
// of 128-row blocks fills every resident slot of the card (two blocks an
// SM), else 64 (4 warps, four an SM), so a small grid keeps its SMs busy
// (`attend_rows`, one rule for every launch, counted by the wrappers in
// `attend_rows`).  Each chunk of k and v in shared memory then serves 128
// rows.  Measured and left out (PERF.md): a third stage, two 16-row tiles a
// warp, the bias through shared memory.
//
// Numerics of the TPU kernels: logit = fl(fl(acc * scale) + bias), -100
// added where band ids differ, keys past Nk at -inf; fp32 softmax on
// ex2.approx (the special-function unit's 2^x) with log2(e) folded into one
// FMA per logit; exp(s - m) rounded to bf16 for the product with v, which
// is scaled by 1/sum after it, the TPU's order for B3.  B4 and B5's TPU
// kernels normalise before they round (p = bf16(exp(s - m) / sum)): the
// same softmax, the same bf16 operand of P v, rounded at a scale one factor
// apart.  Outputs in the three layouts of AttnArgs.
//
// What bounds it on an H100, at GRL-base x4 SR 256^2 (d = 30 in rows of
// DP = 32; 64 windows of 1024 tokens, or 16 stripes of 4096 tokens against
// 1024 anchors; 3 heads): a call computes 201 M logits, each 128 bf16
// tensor-core operations (q k^T and p v at DP = 32: 25.8 GFLOP, 26 us at
// 989 TFLOP/s), one exp (48 us on the special-function units' 16 a clock an
// SM) and about ten more fp32 instructions (scale, bias, mask, max, exponent,
// sum, rounding: about 60 us of issue at 4 a clock an SM); the bias is 2
// bytes a logit (403 MB from L2 a call; a head's 2 MB from HBM about once),
// k and v 8 KB a chunk a block (201 MB from L2 at 128 rows a block).
//
// The bias is shared by every region, and the grid puts the region (B x
// windows or stripes) fastest, then the row tile, then the head, so the
// blocks in flight at one time read the same bias rows of one head for
// every region: each bias tile comes from HBM about once and from L2 for
// the other B x regions readers.
#pragma once

#include <stdint.h>

#include "large_attn.cuh"
#include "mma_util.cuh"

namespace grlir {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;    // 4 warps
constexpr int kMmaRows = 64;        // query rows (attention) or tokens (projection) a block
constexpr int kMmaKeys = 64;        // keys a chunk

// bf16 smem row of q/k/v of a head padded to DP columns: 80 or 144 B, odd
// multiples of 16 B, so ldmatrix reads them without bank conflicts
template <int DP>
__host__ __device__ constexpr int ld_k() {
  return DP + 8;
}

// ws[g][head][p][t][0..DP) for the parts p < nparts: token t of region g
// times w plus b, unit-normed for the parts set in norm_mask, times
// scale0[head] (part 0) or scale1[head] (part 1) where given (after the
// norm, as the TPU folds its logit scales), rounded to bf16; zeros past d.
// wt: (nparts * heads * d, Cp) bf16, w transposed, row (p * heads + head) *
// d + e holding column e of that part's head in its first C values (rows
// Cp apart, Cp a multiple of 16; the rest is not read); bp: (nparts * heads
// * d,) fp32 in the same order.
// Grid (regions * B, ceil(N / 64), ceil(heads / hp)): block z takes heads
// z hp .. z hp + hp - 1, whose w rows fit its shared memory (all heads at
// the model's widths).  Warp w takes tokens 16w..16w+15 of the tile and
// one head's DP columns at a time.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
mma_project_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                   const float* __restrict__ bp, const float* __restrict__ scale0,
                   const float* __restrict__ scale1, bf16* __restrict__ ws, Regions reg, int C,
                   int Cp, int heads, int d, int nparts, int norm_mask, int hp) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int h0 = blockIdx.z * hp, nh = min(hp, heads - h0);
  const int ld = Cp + 8, ncols = nparts * nh * DP;
  const int N = reg.rh * reg.rw, g = blockIdx.x, t0 = blockIdx.y * kMmaRows;
  const int nt = min(kMmaRows, N - t0);
  int* pix = reinterpret_cast<int*>(mma_smem);                  // [64]
  float* bsm = reinterpret_cast<float*>(pix + kMmaRows);        // [ncols]
  bf16* xs = reinterpret_cast<bf16*>(bsm + ncols);              // [64][ld]
  bf16* wsm = xs + kMmaRows * ld;                               // [ncols][ld]
  const int tid = threadIdx.x;

  for (int i = tid; i < kMmaRows; i += kMmaThreads) pix[i] = i < nt ? reg.pixel(g, t0 + i) : 0;
  // w and b of the block's heads: each head's d rows (values) into DP of
  // shared memory (row (p nh + hl) DP + e for head h0 + hl), zeros past d
  // and past C
  auto src_row = [&](int r) {  // row of wt and bp of shared row r
    const int ph = r / DP;
    return (size_t)((ph / nh) * heads + h0 + ph % nh) * d + r % DP;
  };
  for (int r = tid; r < ncols; r += kMmaThreads) bsm[r] = r % DP < d ? bp[src_row(r)] : 0.f;
  for (int i = tid; i < ncols * (Cp / 8); i += kMmaThreads) {
    const int r = i / (Cp / 8), c = (i % (Cp / 8)) * 8, e = r % DP;
    const int bytes = e < d ? 2 * max(0, min(8, C - c)) : 0;
    cp_async16_first(wsm + r * ld + c, bytes ? wt + src_row(r) * Cp + c : wt, bytes);
  }
  __syncthreads();  // pix, bsm
  // x rows (2C bytes, 8-byte aligned when C % 4 == 0): 8-byte copies, or
  // element loads; zeros past C and past the region's last token
  const bool vec = C % 4 == 0;
  for (int i = tid; i < kMmaRows * (Cp / 4); i += kMmaThreads) {
    const int r = i / (Cp / 4), c = (i % (Cp / 4)) * 4;
    bf16* dst = xs + r * ld + c;
    const bf16* src = x + (size_t)pix[r] * C + c;
    if (vec && r < nt && c < C) {
      cp_async8(dst, src, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (r < nt && c + e < C) ? src[e] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32, gr = lane / 4, qd = lane % 4, mi = lane / 8;
  for (int ph = 0; ph < nparts * nh; ++ph) {
    const int p = ph / nh, hh = h0 + ph % nh;
    float acc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kk = 0; kk < Cp / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, xs + (warp * 16 + (mi & 1) * 8 + lane % 8) * ld + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        unsigned b[4];
        ldmatrix_x4(b, wsm + (ph * DP + n * 8 + (mi >> 1) * 8 + lane % 8) * ld + kk * 16 +
                           (mi & 1) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    // fp32 bias, then the unit norm over the head's DP columns: a row's
    // columns sit in the 4 lanes of a quad
    const float* bb = bsm + ph * DP;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += bb[n * 8 + 2 * qd + (e & 1)];
    if (norm_mask >> p & 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ss = 0.f;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          ss = fmaf(acc[n][2 * r], acc[n][2 * r], ss);
          ss = fmaf(acc[n][2 * r + 1], acc[n][2 * r + 1], ss);
        }
        const float inv = rsqrtf(fmaxf(quad_sum(ss), 1e-24f));
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[n][2 * r] *= inv;
          acc[n][2 * r + 1] *= inv;
        }
      }
    }
    const float* scale = p == 0 ? scale0 : p == 1 ? scale1 : nullptr;
    if (scale) {
      const float sc = scale[hh];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= sc;
    }
    bf16* out = ws + (((size_t)g * heads + hh) * nparts + p) * N * DP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = warp * 16 + gr + 8 * r;
      if (t >= nt) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<unsigned*>(out + (size_t)(t0 + t) * DP + n * 8 + 2 * qd) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// out[r][0..dp) = in[r][0..d), zeros past d.
__global__ void __launch_bounds__(kThreads)
pad_rows_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, long long rows, int d,
                int dp) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < rows * dp;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / dp;
    const int e = static_cast<int>(i % dp);
    out[i] = e < d ? in[r * d + e] : __float2bfloat16(0.f);
  }
}

// The two-pass softmax of the attention kernels, one warp's 16 rows
// against a chunk of 64 keys, in the mma accumulator layout: s[j][e] is
// row lane / 4 + 8 (e / 2) and key 8 j + 2 (lane % 4) + e % 2.  Pass 1
// folds each chunk's logits into the rows' running max and sum, pass 2
// recomputes them with the same sequence, bit-equal, and multiplies the
// exps by v.  One copy serves every kernel, so the two passes cannot drift.

// s = q . k^T for the warp's rows (A fragments qa: KS k-steps of 16, a
// head of 16 KS columns) and the chunk's keys (rows of 16 KS + 8 bf16 in
// shared memory); tiles of keys past nk are skipped (0).
template <int KS>
__device__ __forceinline__ void chunk_qk(const unsigned (&qa)[KS][4], const bf16* ks, int nk,
                                         int lane, float (&s)[8][4]) {
  constexpr int ld = KS * 16 + 8;
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (j * 8 >= nk) continue;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      unsigned b[4];
      ldmatrix_x4(b, ks + (j * 8 + lane % 8) * ld + kk * 16 + mi * 8);
      mma_bf16(s[j], qa[kk], b[0], b[1]);
      mma_bf16(s[j], qa[kk + 1], b[2], b[3]);
    }
  }
}

// b = bias[row][key] of an fp32 bias in the accumulator layout of s (the
// thread's rows r0 and r0 + 8 in rows[0], rows[1], each pointing at the
// chunk's first key, or null past the last query row; 0 for keys from nk).
// All 32 loads are issued before any is used: the caller loads before its
// products, so their trips to L2 overlap them.
__device__ __forceinline__ void load_bias_f32(float (&b)[8][4], const float* const (&rows)[2],
                                              int nk, int lane) {
  const int qd = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * qd + (e & 1);
      const float* row = rows[e >> 1];
      b[j][e] = row && key < nk ? __ldg(row + key) : 0.f;
    }
}

// -100 where the key's band id (bk, in shared memory, 8-byte aligned; null:
// no mask) differs from the row's (bq), and -inf for keys past nk.
__device__ __forceinline__ void mask_logits(float (&s)[8][4], const int* bk, const int (&bq)[2],
                                            int nk, int lane) {
  const int qd = lane % 4;
  if (bk) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 bk2 = *reinterpret_cast<const int2*>(bk + j * 8 + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (((e & 1) ? bk2.y : bk2.x) != bq[e >> 1]) s[j][e] += -100.f;
    }
  }
  if (nk < kMmaKeys) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + 2 * qd + (e & 1) >= nk) s[j][e] = -INFINITY;
  }
}

// Pass 1: fold a chunk's logits into this thread's running max m and sum l
// of its two rows.
__device__ __forceinline__ void fold_rows(const float (&s)[8][4], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], mx);
    if (m_new != -INFINITY) {
      const float ml = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += ex2(fmaf(s[j][2 * r], kLog2e, -ml)) + ex2(fmaf(s[j][2 * r + 1], kLog2e, -ml));
      l[r] = fmaf(l[r], ex2((m[r] - m_new) * kLog2e), sum);
      m[r] = m_new;
    }
  }
}

// Between the passes: the rows' max (times log2 e) and 1/sum, the four
// lanes of each quad combined.
__device__ __forceinline__ void finish_rows(const float (&m)[2], const float (&l)[2],
                                            float (&mL)[2], float (&inv_l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mq = quad_max(m[r]);
    mL[r] = mq * kLog2e;
    inv_l[r] = 1.f / quad_sum(l[r] * ex2((m[r] - mq) * kLog2e));
  }
}

// Pass 2: o += p v over a chunk whose first nk keys are valid, p =
// bf16(exp(s - max)) (kDeferred: the caller scales o by 1/sum) or
// bf16(exp(s - max) / sum), rounded in the A-fragment layout of P v (key
// tiles 2k, 2k+1 make k-step k); v rows of 8 NT + 8 bf16 in shared memory,
// o NT tiles of 8 columns.
template <bool kDeferred, int NT>
__device__ __forceinline__ void exp_times_v(const float (&s)[8][4], const float (&mL)[2],
                                            const float (&inv_l)[2], const bf16* vs, int nk,
                                            int lane, float (&o)[NT][4]) {
  constexpr int ld = NT * 8 + 8;
  const int mi = lane / 8;
  unsigned pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ex = ex2(fmaf(s[j][e], kLog2e, -mL[e >> 1]));
      p[e] = kDeferred ? ex : ex * inv_l[e >> 1];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk * 16 >= nk) break;  // exps of keys past nk are 0
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      unsigned b[4];
      ldmatrix_x4_trans(b, vs + (kk * 16 + (mi & 1) * 8 + lane % 8) * ld + n * 8 +
                               (mi >> 1) * 8);
      mma_bf16(o[n], pa[kk], b[0], b[1]);
      mma_bf16(o[n + 1], pa[kk], b[2], b[3]);
    }
  }
}

constexpr int kStages = 2;  // chunks in shared memory: one computed, the next in flight

template <int DP>
int launch_mma_project_cols(const void* x, const void* wt, const float* bp, const float* scale0,
                            const float* scale1, void* ws, const Regions& reg, int B, int C,
                            int Cp, int heads, int d, int nparts, int norm_mask,
                            cudaStream_t stream) {
  // as many heads a block as their w rows fit beside the x tile
  auto smem_of = [&](int hp) {
    return kMmaRows * 4 + (size_t)nparts * hp * DP * 4 +
           sizeof(bf16) * (size_t)(kMmaRows + nparts * hp * DP) * (Cp + 8);
  };
  int limit = 0, hp = heads;
  int err = smem_limit(&limit);
  if (err) return err;
  while (hp > 1 && smem_of(hp) > static_cast<size_t>(limit)) --hp;
  err = set_smem(mma_project_kernel<DP>, smem_of(hp));
  if (err) return err;
  const int regions = (reg.H / reg.rh) * (reg.W / reg.rw), N = reg.rh * reg.rw;
  const dim3 grid(B * regions, (N + kMmaRows - 1) / kMmaRows, (heads + hp - 1) / hp);
  mma_project_kernel<DP><<<grid, kMmaThreads, smem_of(hp), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), bp, scale0, scale1,
      static_cast<bf16*>(ws), reg, C, Cp, heads, d, nparts, norm_mask, hp);
  return static_cast<int>(cudaGetLastError());
}

// Launch mma_project_kernel into rows of head_cols(d); returns 0, -1 (d > 64
// or shared memory) or a cudaError_t.  scale0, scale1: (heads,) fp32
// multipliers of parts 0 and 1 after the norm, or null.
int launch_mma_project(const void* x, const void* wt, const float* bp, const float* scale0,
                       const float* scale1, void* ws, const Regions& reg, int B, int C, int Cp,
                       int heads, int d, int nparts, int norm_mask, cudaStream_t stream) {
  if (d > kMaxD) return -1;
  if (d <= 32)
    return launch_mma_project_cols<32>(x, wt, bp, scale0, scale1, ws, reg, B, C, Cp, heads, d,
                                       nparts, norm_mask, stream);
  return launch_mma_project_cols<64>(x, wt, bp, scale0, scale1, ws, reg, B, C, Cp, heads, d,
                                     nparts, norm_mask, stream);
}

// Launch pad_rows_kernel (rows of d -> rows of head_cols(d)); returns 0 or a
// cudaError_t.
int launch_pad_rows(const void* in, void* out, long long rows, int d, cudaStream_t stream) {
  const int dp = head_cols(d);
  long long blocks = (rows * dp + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  pad_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(in), static_cast<bf16*>(out), rows, d, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace grlir
