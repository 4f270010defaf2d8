// Anchored-stripe half of GRL's mixed attention for stripes whose biases
// fit the TPU's resident budget (GRL-S: stripes 8x64 and 64x8 at df 4, N1 =
// 512 tokens, N2 = 32 anchors).
//
// Replaces the Pallas kernel `_stripe_block_kernel`, resident-bias path
// (grlir/ops/pallas/block_attn.py:589-719, entry `fused_stripe_half`).  For
// one stripe of N1 tokens and its N2 = N1/df^2 anchor tokens it computes
//   a2w: x1 = softmax_N1(norm(anchor) . (norm(k) s1)^T + bias_a2w + mask) v
//   w2a: y  = softmax_N2((norm(q) s2) . norm(anchor)^T + bias_w2a + mask) x1
// reading x in NHWC with the cyclic stripe shift applied while reading (the
// anchor arrives already rolled) and writing y in NHWC, in rolled
// coordinates.  Horizontal and vertical stripes are the same code.  Both
// softmaxes are deferred as on the TPU: exp(s - max) in fp32, rounded to
// x's type for the product, which is then scaled by 1/sum; the biases stay
// fp32; x1 is rounded to x's type before w2a.
//
// What bounds it on an H100: the TPU kernel keeps the whole (h, N2, N1)
// logit matrix and both biases resident (up to 4 MB); a Hopper block has at
// most 227 KB of shared memory.  Per launch at GRL-S 256^2 the qkv
// projection is 3.2 GFLOP and the two attentions 1.1; the bytes that must
// move are x and y, 25 MB.
//
// bf16 (the served route, `grlir_stripe_half_mma`): two kernels on tensor
// cores, mma.sync m16n8k16 with bf16 operands and fp32 sums.
// mma_project_kernel (stripe_attn_mma.cuh) writes q (unit-normed, times
// s2), k (unit-normed, times s1) and v of every stripe into workspace rows
// of 32 or 64 (zeros past d, so that d = 30 keeps 16-byte copies); the
// workspace (25 MB at GRL-S 256^2) stays in the 50 MB
// L2 for mma_stripe_resident_kernel, one block of 4 warps per (stripe,
// head).  That block unit-norms the stripe's anchors into shared memory,
// runs a2w with 16 anchor rows a warp against k and v streamed in chunks of
// 64 (cp.async, double-buffered; two passes: max and sum, then the rounded
// exps times v), keeps x1 in shared memory, then runs w2a with 16 stripe
// tokens a warp against the resident anchors and x1.  The workspace round
// trip costs about twice the bytes of x and y.  Head dim <= 64 (one row of
// the workspace).
//
// fp32 (`grlir_stripe_half`): the TPU kernel then computes in fp32, and
// TF32 products would not hold it, so the route stays on CUDA cores:
// stripe_half_kernel streams the N1 tokens in tiles of 64, twice: pass A
// projects k and v per tile and folds the tile into an online (running max
// and sum) softmax over N1 for every anchor row; pass B projects q per
// tile, and its softmax over N2 is complete per token.  Shared memory then
// holds one tile, the anchor and x1, whatever N1 is (every N2 <= 128 at d
// <= 64 fits); FMA issue and shared-memory traffic bound it.
#include <algorithm>

#include "stripe_attn_mma.cuh"

namespace grlir {

__global__ void __launch_bounds__(kThreads)
stripe_half_kernel(const float* __restrict__ x, const float* __restrict__ anchor,
                   const float* __restrict__ w, const float* __restrict__ bqkv,
                   const float* __restrict__ scale1, const float* __restrict__ scale2,
                   const float* __restrict__ bias_a2w, const float* __restrict__ bias_w2a,
                   const int* __restrict__ bands, const int* __restrict__ bands_a,
                   float* __restrict__ y, int H, int W, int C, int Cs, int heads, int sh, int sw,
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
    an[a * lda + e] = anchor[p * Cs + hh * d + e];
    acc[a * lda + e] = 0.f;
  }
  for (int a = threadIdx.x; a < N2; a += kThreads) {
    mrow[a] = -INFINITY;
    lrow[a] = 0.f;
  }
  __syncthreads();
  normalize_rows<float>(an, N2, d, lda, 1.f);

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
    project_tile<float>(x, pix, nt, C, w, 3 * Cs, bqkv, cols, 2 * d, scratch, tile, ldt);
    normalize_rows<float>(tile, nt, d, ldt, scale1[hh]);
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
        s[t] = e;
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
  // x1 = sums / row sum, the second product's operand
  for (int i = threadIdx.x; i < N2 * d; i += kThreads) {
    const int a = i / d, e = i % d;
    acc[a * lda + e] *= 1.f / lrow[a];
  }

  // pass B (w2a): q per tile, softmax over N2 per token, times x1
  for (int j = threadIdx.x; j < d; j += kThreads) cols[j] = hh * d + j;
  for (int t0 = 0; t0 < N1; t0 += kTileRows) {
    const int nt = min(kTileRows, N1 - t0);
    __syncthreads();
    load_pixels(t0, nt);
    __syncthreads();
    project_tile<float>(x, pix, nt, C, w, 3 * Cs, bqkv, cols, d, scratch, tile, ldt);
    normalize_rows<float>(tile, nt, d, ldt, scale2[hh]);
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
        p[a] = e;
      }
      const float inv = 1.f / warp_sum(sum);
      __syncwarp();
      const int tt = t0 + t;
      float* out = y + ((size_t)(b * H + sy * sh + tt / sw) * W + sx * sw + tt % sw) * Cs + hh * d;
      for (int e = lane; e < d; e += 32) {
        float o = 0.f;
        for (int a = 0; a < N2; ++a) o = fmaf(p[a], acc[a * lda + e], o);
        out[e] = o * inv;
      }
      __syncwarp();
    }
  }
}

int launch_stripe_half(const float* x, const float* anchor, const float* w, const float* bqkv,
                       const float* s1, const float* s2, const float* b1, const float* b2,
                       const int* bands, const int* bands_a, float* y, int B, int H, int W,
                       int C, int Cs, int heads, int sh, int sw, int df, int shift_h,
                       int shift_w, cudaStream_t stream) {
  const int d = Cs / heads, N2 = (sh / df) * (sw / df);
  const size_t smem =
      sizeof(float) *
      (kTileRows + 2 * d + std::max(kProjScratch, std::max(N2 * (kTileRows + 1), kWarps * N2)) +
       kTileRows * (2 * d + 1) + 2 * N2 * (d + 1) + 2 * N2);
  auto kernel = stripe_half_kernel;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(B * (H / sh) * (W / sw), heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      x, anchor, w, bqkv, s1, s2, b1, b2, bands, bands_a, y, H, W, C, Cs, heads, sh, sw, df,
      shift_h, shift_w);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16 on tensor cores

namespace {

constexpr int kMmaWarps = kMmaThreads / 32;

// Logits of a warp's 16 rows (A fragments qa) against a chunk of 64 keys
// (rows of KS * 16 + 8 in shared memory, the first nk valid), plus the fp32
// bias bias[row][c0 + key] (the warp's rows start at row0; rows of ld columns;
// rows past nrows take 0), -100 where the band ids of row and key differ
// (bk null: no mask); keys past nk are -inf.  bias_vec: 8-byte bias loads
// (ld even).
template <int KS>
__device__ __forceinline__ void chunk_logits(const unsigned (&qa)[KS][4], const bf16* ks, int nk,
                                             const float* bias, int ld, int row0, int nrows,
                                             int c0, bool bias_vec, const int* bk,
                                             const int (&bq)[2], int lane, float (&s)[8][4]) {
  const int gr = lane / 4, qd = lane % 4;
  chunk_qk(qa, ks, nk, lane, s);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    if (row >= nrows) continue;
    const float* brow = bias + (size_t)row * ld + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * qd;
      if (col >= nk) continue;
      float2 bv;
      if (bias_vec) {
        bv = __ldg(reinterpret_cast<const float2*>(brow + col));
      } else {
        bv.x = __ldg(brow + col);
        bv.y = col + 1 < nk ? __ldg(brow + col + 1) : 0.f;
      }
      s[j][2 * r] += bv.x;
      s[j][2 * r + 1] += bv.y;
    }
  }
  mask_logits(s, bk, bq, nk, lane);
}

// bytes of one a2w pipeline stage: k and v chunks (rows of DP + 8) and
// their band ids
template <int DP>
__host__ __device__ constexpr int res_stage() {
  return 2 * kMmaKeys * ld_k<DP>() * 2 + kMmaKeys * 4;
}
static_assert(res_stage<32>() % 16 == 0 && res_stage<64>() % 16 == 0, "16-byte aligned stages");

// Shared memory of mma_stripe_resident_kernel<DP> for N2 anchors: anchors,
// x1 (rows of DP + 8, N2 rounded up to a key chunk) and their band ids,
// then the stages.
template <int DP>
size_t resident_smem(int N2) {
  const size_t n2p = (N2 + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
  return n2p * (2 * ld_k<DP>() * sizeof(bf16) + 4) + kStages * res_stage<DP>();
}

// Both attentions of one (stripe, head); see the note at the top.  ws:
// [stripe][head][q|k|v][N1][DP] from mma_project_kernel (q times s2, k
// times s1); anchor (B, H/df, W/df, Cs) rolled; bias1 (heads, N2, N1),
// bias2 (heads, N1, N2) fp32; bands (stripes, N1) and bands_a (stripes,
// N2) or null; y (B, H, W, Cs).  Grid (groups * heads), the stripe fastest.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
mma_stripe_resident_kernel(const bf16* __restrict__ ws, const bf16* __restrict__ anchor,
                           const float* __restrict__ bias1, const float* __restrict__ bias2,
                           const int* __restrict__ bands, const int* __restrict__ bands_a,
                           bf16* __restrict__ y, int H, int W, int Cs, int heads, int sh, int sw,
                           int df, int groups) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  constexpr int kLdK = ld_k<DP>(), kResStage = res_stage<DP>();
  const int g = blockIdx.x % groups, hh = blockIdx.x / groups;
  const int ah = sh / df, aw = sw / df, N1 = sh * sw, N2 = ah * aw, d = Cs / heads;
  const int n2p = (N2 + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
  const int regions = (H / sh) * (W / sw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gr = lane / 4, qd = lane % 4, mi = lane / 8;
  const bf16* qp = ws + ((size_t)g * heads + hh) * 3 * N1 * DP;
  const bf16* kp = qp + (size_t)N1 * DP;
  const bf16* vp = kp + (size_t)N1 * DP;
  const float* b1 = bias1 + (size_t)hh * N2 * N1;
  const float* b2 = bias2 + (size_t)hh * N1 * N2;
  const int* bt = bands ? bands + (size_t)(g % regions) * N1 : nullptr;
  const int* bta = bands ? bands_a + (size_t)(g % regions) * N2 : nullptr;

  bf16* an = reinterpret_cast<bf16*>(mma_smem);   // [n2p][kLdK] unit anchors
  bf16* x1 = an + n2p * kLdK;                     // [n2p][kLdK] a2w output
  int* ban = reinterpret_cast<int*>(x1 + n2p * kLdK);  // [n2p] anchor band ids
  unsigned char* stages = reinterpret_cast<unsigned char*>(ban + n2p);

  // a2w streams k (both passes) and v (pass 2) through the stages
  const int nch = (N1 + kMmaKeys - 1) / kMmaKeys, total = 2 * nch;
  auto load = [&](int it) {
    const int pass = it >= nch, c0 = (it - pass * nch) * kMmaKeys;
    bf16* ks = reinterpret_cast<bf16*>(stages + (it % kStages) * kResStage);
    bf16* vs = ks + kMmaKeys * kLdK;
    int* bks = reinterpret_cast<int*>(vs + kMmaKeys * kLdK);
    for (int i = tid; i < kMmaKeys * (DP / 8); i += kMmaThreads) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool ok = c0 + r < N1;
      const size_t off = (size_t)(ok ? c0 + r : 0) * DP + c;
      cp_async16(ks + r * kLdK + c, kp + off, ok);
      if (pass) cp_async16(vs + r * kLdK + c, vp + off, ok);
    }
    if (bt && tid < kMmaKeys) {
      const bool ok = c0 + tid < N1;
      cp_async4(bks + tid, ok ? bt + c0 + tid : bt, ok);
    }
  };
  load(0);  // in flight while the anchors are normed
  cp_async_commit();

  // the stripe's anchors, unit-normed and rounded (one warp a token, lanes
  // e and e + 32 channels e and e + 32), zero rows past N2; x1 zeroed
  const Regions areg{H / df, W / df, ah, aw, 0, 0};
  for (int a = warp; a < n2p; a += kMmaWarps) {
    float v[DP / 32], ss = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      const int e = lane + 32 * i;
      v[i] = a < N2 && e < d
                 ? __bfloat162float(anchor[(size_t)areg.pixel(g, a) * Cs + hh * d + e])
                 : 0.f;
      ss = fmaf(v[i], v[i], ss);
    }
    const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      an[a * kLdK + lane + 32 * i] = __float2bfloat16(v[i] * inv);
      x1[a * kLdK + lane + 32 * i] = __float2bfloat16(0.f);
    }
    if (lane == 0) ban[a] = bta && a < N2 ? bta[a] : 0;
  }

  // a2w: 16 anchor rows a warp, 64 a round, against the N1 keys in chunks
  const bool vec1 = N1 % 2 == 0, vec2 = N2 % 2 == 0;
  const int rounds = (N2 + kMmaRows - 1) / kMmaRows;
  for (int rd = 0; rd < rounds; ++rd) {
    if (rd > 0) {  // the previous round consumed every stage
      load(0);
      cp_async_commit();
    }
    const int row0 = rd * kMmaRows + warp * 16;
    const bool active = row0 < N2;
    unsigned qa[DP / 16][4];
    int bq[2] = {0, 0};
    float m_t[2] = {-INFINITY, -INFINITY}, l_t[2] = {0.f, 0.f};
    float mL[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
    float o[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int it = 0; it < total; ++it) {
      if (it + 1 < total) load(it + 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int pass = it >= nch, c0 = (it - pass * nch) * kMmaKeys;
      if (active) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            ldmatrix_x4(qa[kk], an + (row0 + (mi & 1) * 8 + lane % 8) * kLdK + kk * 16 +
                                    (mi >> 1) * 8);
          bq[0] = ban[row0 + gr];
          bq[1] = ban[row0 + gr + 8];
        }
        if (it == nch) finish_rows(m_t, l_t, mL, inv_l);
        const bf16* ks = reinterpret_cast<const bf16*>(stages + (it % kStages) * kResStage);
        const bf16* vs = ks + kMmaKeys * kLdK;
        const int* bks = reinterpret_cast<const int*>(vs + kMmaKeys * kLdK);
        float s[8][4];
        chunk_logits(qa, ks, min(kMmaKeys, N1 - c0), b1, N1, row0, N2, c0, vec1,
                     bt ? bks : nullptr, bq, lane, s);
        if (!pass) {
          fold_rows(s, m_t, l_t);
        } else {
          exp_times_v<true>(s, mL, inv_l, vs, min(kMmaKeys, N1 - c0), lane, o);
        }
      }
      __syncthreads();  // the stage is consumed before the next load refills it
    }
    // x1 = (e v) / sum, rounded to bf16: the w2a product's operand
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + gr + 8 * r;
        if (row >= N2) continue;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          *reinterpret_cast<unsigned*>(x1 + row * kLdK + n * 8 + 2 * qd) =
              pack_bf16(o[n][2 * r] * inv_l[r], o[n][2 * r + 1] * inv_l[r]);
      }
    }
  }
  __syncthreads();  // x1 complete

  // w2a: 16 stripe tokens a warp against the resident anchors and x1; one
  // chunk of keys (N2 <= 64) keeps its logits from the statistics pass
  const Regions reg{H, W, sh, sw, 0, 0};  // y in rolled coordinates
  const int nchb = n2p / kMmaKeys;
  for (int t0 = warp * 16; t0 < N1; t0 += kMmaWarps * 16) {
    unsigned qa[DP / 16][4];
    int bq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + gr + 8 * r;
      const bool ok = t < N1;
      const bf16* qrow = qp + (size_t)(ok ? t : 0) * DP + 2 * qd;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        qa[kk][r] = ok ? __ldg(reinterpret_cast<const unsigned*>(qrow + kk * 16)) : 0u;
        qa[kk][r + 2] = ok ? __ldg(reinterpret_cast<const unsigned*>(qrow + kk * 16 + 8)) : 0u;
      }
      bq[r] = bt && ok ? bt[t] : 0;
    }
    float m_t[2] = {-INFINITY, -INFINITY}, l_t[2] = {0.f, 0.f}, mL[2], inv_l[2];
    float o[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float s[8][4];
    for (int c = 0; c < nchb; ++c) {
      const int c0 = c * kMmaKeys;
      chunk_logits(qa, an + c0 * kLdK, min(kMmaKeys, N2 - c0), b2, N2, t0, N1, c0, vec2,
                   bt ? ban + c0 : nullptr, bq, lane, s);
      fold_rows(s, m_t, l_t);
    }
    finish_rows(m_t, l_t, mL, inv_l);
    for (int c = 0; c < nchb; ++c) {
      const int c0 = c * kMmaKeys;
      if (nchb > 1)
        chunk_logits(qa, an + c0 * kLdK, min(kMmaKeys, N2 - c0), b2, N2, t0, N1, c0, vec2,
                     bt ? ban + c0 : nullptr, bq, lane, s);
      exp_times_v<true>(s, mL, inv_l, x1 + c0 * kLdK, min(kMmaKeys, N2 - c0), lane, o);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + gr + 8 * r;
      if (t >= N1) continue;
      bf16* out = y + (size_t)reg.pixel(g, t) * Cs + hh * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int e = n * 8 + 2 * qd;
        if (e < d) out[e] = __float2bfloat16(o[n][2 * r] * inv_l[r]);
        if (e + 1 < d) out[e + 1] = __float2bfloat16(o[n][2 * r + 1] * inv_l[r]);
      }
    }
  }
}

// The bf16 route: the projection, then mma_stripe_resident_kernel<DP>.
// Returns 0, -1 (shared memory) or a cudaError_t.
template <int DP>
int launch_stripe_half_mma_cols(const void* x, const void* anchor, const void* wt,
                                const float* bp, const float* s1, const float* s2,
                                const float* b1, const float* b2, const int* bands,
                                const int* bands_a, void* ws, void* y, int B, int H, int W, int C,
                                int Cs, int heads, int sh, int sw, int df, int shift_h,
                                int shift_w, int Cp, cudaStream_t stream) {
  const size_t smem = resident_smem<DP>((sh / df) * (sw / df));
  int err = set_smem(mma_stripe_resident_kernel<DP>, smem);
  if (err) return err;
  // q (unit-normed, times s2), k (unit-normed, times s1), v
  const Regions reg{H, W, sh, sw, shift_h, shift_w};
  err = launch_mma_project(x, wt, bp, s2, s1, ws, reg, B, C, Cp, heads, Cs / heads, 3, 0b011,
                           stream);
  if (err) return err;
  const int groups = B * (H / sh) * (W / sw);
  const long long blocks = (long long)groups * heads;
  if (blocks > 0x7fffffffLL) return -1;
  mma_stripe_resident_kernel<DP><<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(ws), static_cast<const bf16*>(anchor), b1, b2, bands, bands_a,
      static_cast<bf16*>(y), H, W, Cs, heads, sh, sw, df, groups);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route in rows of head_cols(d); -1 as well for d > 64.
int launch_stripe_half_mma(const void* x, const void* anchor, const void* wt, const float* bp,
                           const float* s1, const float* s2, const float* b1, const float* b2,
                           const int* bands, const int* bands_a, void* ws, void* y, int B, int H,
                           int W, int C, int Cs, int heads, int sh, int sw, int df, int shift_h,
                           int shift_w, int Cp, cudaStream_t stream) {
  const int d = Cs / heads;
  if (d > kMaxD) return -1;
  if (d <= 32)
    return launch_stripe_half_mma_cols<32>(x, anchor, wt, bp, s1, s2, b1, b2, bands, bands_a, ws,
                                           y, B, H, W, C, Cs, heads, sh, sw, df, shift_h,
                                           shift_w, Cp, stream);
  return launch_stripe_half_mma_cols<64>(x, anchor, wt, bp, s1, s2, b1, b2, bands, bands_a, ws,
                                         y, B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w,
                                         Cp, stream);
}

}  // namespace
}  // namespace grlir

// fp32.  x (B, H, W, C) unrolled; anchor (B, H/df, W/df, Cs) rolled; w (C,
// 3Cs); bqkv (3Cs,); s1, s2 (heads,) scales; b1 (heads, N2, N1); b2 (heads,
// N1, N2); all fp32; bands (stripes, N1) and bands_a (stripes, N2) int32,
// or both null; y (B, H, W, Cs), rolled coordinates.  Returns 0 on success,
// -1 when the stripe does not fit in shared memory, or the cudaError_t of a
// failed launch.
extern "C" int grlir_stripe_half(const void* x, const void* anchor, const void* w,
                                 const float* bqkv, const float* s1, const float* s2,
                                 const float* b1, const float* b2, const int* bands,
                                 const int* bands_a, void* y, int B, int H, int W, int C,
                                 int Cs, int heads, int sh, int sw, int df, int shift_h,
                                 int shift_w, void* stream) {
  return grlir::launch_stripe_half(
      static_cast<const float*>(x), static_cast<const float*>(anchor),
      static_cast<const float*>(w), bqkv, s1, s2, b1, b2, bands, bands_a,
      static_cast<float*>(y), B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w,
      static_cast<cudaStream_t>(stream));
}

// bf16 on tensor cores.  x, anchor and y as for the fp32 entry in bf16; s1,
// s2, b1, b2 as for the fp32 entry; wt (3Cs, Cp) bf16: w transposed, rows
// Cp apart (C rounded up to 16; values past C are not read); bp (3Cs,)
// fp32; ws: B * stripes * heads * 3 * N1 * DP bf16 (DP = 32 for d <= 32,
// else 64).  Returns -1 as well for d > 64.
extern "C" int grlir_stripe_half_mma(const void* x, const void* anchor, const void* wt,
                                     const float* bp, const float* s1, const float* s2,
                                     const float* b1, const float* b2, const int* bands,
                                     const int* bands_a, void* ws, void* y, int B, int H, int W,
                                     int C, int Cs, int heads, int sh, int sw, int df,
                                     int shift_h, int shift_w, int Cp, void* stream) {
  return grlir::launch_stripe_half_mma(x, anchor, wt, bp, s1, s2, b1, b2, bands, bands_a, ws,
                                       y, B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w,
                                       Cp, static_cast<cudaStream_t>(stream));
}
