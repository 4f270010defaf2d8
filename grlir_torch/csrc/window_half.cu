// Window half of GRL's mixed attention for windows of at most 512 tokens.
//
// Replaces the Pallas kernel `_window_block_kernel`, small-window branch
// (grlir/ops/pallas/block_attn.py:214-310, entry `fused_window_half`).  It
// reads the block input x in NHWC, applies the cyclic window shift while
// reading, projects q, k and v of each head, runs cosine attention with the
// continuous position bias (fp32, as the TPU keeps it on this branch:
// `pack_window_bias(..., out_dtype=f32)`, :385-387) and the shift-band
// mask, and writes the head's output channels in NHWC, in rolled
// coordinates (the caller un-rolls).  Numerics of the TPU branch: qkv = x w
// with operands in x's type and fp32 sums, plus b in fp32; q and k
// unit-normed in fp32, q times exp(min(s, log 100)) before rounding (:268-
// 272); logits as fp32 sums plus the fp32 bias, -100 where band ids differ;
// e = exp(s - max) in fp32, the row sum over the unrounded e, the product
// with v on e rounded to x's type, scaled by 1/sum after it (:287-303).
//
// Two routes, chosen by x's type before any launch:
//
// bf16 (the served route, `grlir_window_half_mma`): one fused kernel on
// tensor cores, one launch a call.  A persistent grid (as many blocks as
// fit on the SMs) walks the windows.  Each block holds the transposed w of
// the heads (each head zero-padded to 32 or 64 columns, rounded to bf16
// from where the model keeps it: no packed copy of w is made) and the fp32
// bias vector in shared memory, loaded once when all heads fit, else one
// head at a time.  For each window and head: the x rows of 64 rolled tokens
// are gathered with cp.async, prefetched while the previous head attends;
// mma.sync m16n8k16 projects them (bf16 operands, fp32 sums, 16 tokens a
// warp); bias, unit norm, q's scale and the bf16 rounding run in the
// accumulator layout; q, k and v of the head stay in shared memory; then
// each warp attends 16 query rows against the keys in chunks of 64 with the
// softmax helpers of stripe_attn_mma.cuh (one chunk at N = 64: the logits
// stay in registers between the max, the sum and P v), the fp32 bias rows
// read from L2 straight into the accumulator layout.  No q/k/v workspace
// goes through device memory.  What bounds it on an H100: the bytes (x and
// y once, the bias from L2), 0.0076 ms at GRL-S 256^2; at that size the
// projection is ~75% of its tensor-core FLOPs.
//
// fp32 (`grlir_window_half`): the TPU kernel then computes in fp32, and
// TF32 products would not hold it, so the route stays on CUDA cores: one
// block per (window, head) keeps every intermediate (qkv, the logits, the
// probabilities) in shared memory.  The projection stages x and w in
// 32-channel chunks and keeps a 4x8 register tile per thread (12 shared
// loads per 32 FMAs); attention runs one warp per query row.  Its sums run
// in the order of a plain fp32 GEMM's (sequential FMAs over the reduced
// axis).
#include <algorithm>

#include "stripe_attn_mma.cuh"

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

namespace grlir {
namespace {

// Operands of window_half_mma_kernel.  x (B, H, W, C) bf16 unrolled; w
// (C, 3Cw) fp32 or bf16 (w_bf16) read through its element strides over
// input channels (w_sc) and columns (w_scol); b (3Cw,) fp32; scale (heads,)
// fp32 exp(min(logit_scale, log 100)); bias (heads, N, N) fp32; bands
// (windows, N) int32 or null; y (B, H, W, Cw) bf16.  Cp: C rounded up to
// 16; hp: heads whose w shared memory holds at once (all, or one).
struct WinMmaArgs {
  const bf16* x;
  const void* w;
  long long w_sc, w_scol;
  int w_bf16;
  const float* b;
  const float* scale;
  const float* bias;
  const int* bands;
  bf16* y;
  int B, H, W, C, Cp, Cw, heads, d, wh, ww, shift, hp;
};

// Shared memory of window_half_mma_kernel, byte offsets: w rows (hp heads
// x 3 parts x DP columns, Cp + 8 bf16 each), one x tile (64 rows of Cp + 8
// bf16), q, k and v of one head (NT = N rounded up to 64 rows of DP + 8
// bf16), the bias vector of the hp heads (fp32), and the band ids of two
// windows (the next one's arrive while the current one attends).  Rows of
// odd multiples of 16 bytes keep ldmatrix free of bank conflicts.
template <int DP>
struct WinLayout {
  int ldw, ldq, NT;
  size_t w_off, x_off, q_off, k_off, v_off, b_off, band_off, bytes;
  __host__ __device__ WinLayout(int Cp, int N, int hp) {
    ldw = Cp + 8;
    ldq = DP + 8;
    NT = (N + 63) / 64 * 64;
    size_t o = 0;
    w_off = o;
    o += (size_t)hp * 3 * DP * ldw * 2;
    x_off = o;
    o += (size_t)64 * ldw * 2;
    q_off = o;
    o += (size_t)NT * ldq * 2;
    k_off = o;
    o += (size_t)NT * ldq * 2;
    v_off = o;
    o += (size_t)NT * ldq * 2;
    b_off = o;
    o += (size_t)hp * 3 * DP * 4;
    band_off = o;
    o += (size_t)2 * NT * 4;
    bytes = o;
  }
};

// The bf16 window half, see the note at the top.  DP: the head's columns in
// shared memory (32 or 64, zeros past d).  Grid: persistent, block b takes
// windows b, b + gridDim.x, ...; each (window, head) is a sequence of
// projection steps of 64 tokens, then the head's attention.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
window_half_mma_kernel(WinMmaArgs a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  constexpr int KS = DP / 16, NTL = DP / 8;  // k-steps of q k^T, column tiles of P v
  const int N = a.wh * a.ww, h = a.heads, d = a.d, C = a.C, Cp = a.Cp;
  const WinLayout<DP> L(Cp, N, a.hp);
  bf16* wsm = reinterpret_cast<bf16*>(mma_smem + L.w_off);
  bf16* xs = reinterpret_cast<bf16*>(mma_smem + L.x_off);
  bf16* qs = reinterpret_cast<bf16*>(mma_smem + L.q_off);
  bf16* ks = reinterpret_cast<bf16*>(mma_smem + L.k_off);
  bf16* vs = reinterpret_cast<bf16*>(mma_smem + L.v_off);
  float* bsm = reinterpret_cast<float*>(mma_smem + L.b_off);
  int* bnd = reinterpret_cast<int*>(mma_smem + L.band_off);
  const Regions out_reg{a.H, a.W, a.wh, a.ww, 0, 0};
  const int per_image = (a.H / a.wh) * (a.W / a.ww), nwin = a.B * per_image;
  const int tiles = L.NT / 64, rtiles = (N + 15) / 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gr = lane / 4, qd = lane % 4, mi = lane / 8;

  // w of heads h0..h0+hp: row (hl * 3 + p) * DP + e holds column p * Cw +
  // (h0 + hl) * d + e of w, rounded to bf16, zeros past d and past C; the
  // bias vector in the same order
  // (neighbouring threads on neighbouring addresses of w: input channels
  // fastest when they are contiguous, as in the model's transposed Linear
  // weight, else columns)
  auto load_w = [&](int h0) {
    const int rows = a.hp * 3 * DP;
    const bool c_fast = a.w_sc == 1;
    for (int i = tid; i < rows * Cp; i += kMmaThreads) {
      const int r = c_fast ? i / Cp : i % rows, c = c_fast ? i % Cp : i / rows;
      const int e = r % DP, p = (r / DP) % 3, hl = r / (3 * DP);
      float v = 0.f;
      if (e < d && c < C) {
        const long long off =
            c * a.w_sc + (long long)(p * a.Cw + (h0 + hl) * d + e) * a.w_scol;
        v = a.w_bf16 ? __bfloat162float(static_cast<const bf16*>(a.w)[off])
                     : static_cast<const float*>(a.w)[off];
      }
      wsm[r * L.ldw + c] = __float2bfloat16(v);
    }
    for (int r = tid; r < rows; r += kMmaThreads) {
      const int e = r % DP, p = (r / DP) % 3, hl = r / (3 * DP);
      bsm[r] = e < d ? a.b[p * a.Cw + (h0 + hl) * d + e] : 0.f;
    }
  };
  // x rows of tokens t0..t0+63 of window g (rolled), zeros past C and N:
  // 8-byte copies (x rows 8-byte aligned when C % 4 == 0), or element loads
  const bool vec = C % 4 == 0;
  const int nwx = a.W / a.ww;
  auto load_x = [&](int g, int t0) {
    // the window's first rolled row and column, and its image's first pixel
    const int wi = g % per_image;
    const int y0 = (wi / nwx) * a.wh + a.shift, x0 = (wi % nwx) * a.ww + a.shift;
    const size_t img = (size_t)(g / per_image) * a.H * a.W;
    for (int i = tid; i < 64 * (Cp / 4); i += kMmaThreads) {
      const int r = i / (Cp / 4), c = (i % (Cp / 4)) * 4, t = t0 + r;
      const bool ok = t < N;
      const int ty = t / a.ww;
      int y = y0 + ty, xx = x0 + t - ty * a.ww;  // < 2H, < 2W: one wrap at most
      y -= y >= a.H ? a.H : 0;
      xx -= xx >= a.W ? a.W : 0;
      bf16* dst = xs + r * L.ldw + c;
      const bf16* src = a.x + (ok ? img + (size_t)y * a.W + xx : 0) * C + c;
      if (vec) {
        cp_async8(dst, src, ok && c < C);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = (ok && c + e < C) ? src[e] : __float2bfloat16(0.f);
      }
    }
  };
  auto load_bands = [&](int g, int* dst) {
    for (int t = tid; t < L.NT; t += kMmaThreads)
      dst[t] = t < N ? a.bands[(size_t)(g % per_image) * N + t] : 0;
  };

  // projection steps: (window of this block, head, token tile)
  const int per_win = h * tiles;
  const int my_wins = (nwin - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = my_wins * per_win;
  auto issue = [&](int st) {  // the loads of step st
    const int wi = st / per_win, hh = (st % per_win) / tiles, tile = st % tiles;
    const int g = blockIdx.x + wi * gridDim.x;
    if (a.hp < h && tile == 0) load_w(hh);
    if (tiles > 1 || hh == 0) load_x(g, tile * 64);
    if (a.bands && hh == 0 && tile == 0) load_bands(g, bnd + (wi & 1) * L.NT);
    cp_async_commit();
  };
  if (a.hp == h) load_w(0);
  if (steps > 0) issue(0);

  for (int st = 0; st < steps; ++st) {
    const int wi = st / per_win, hh = (st % per_win) / tiles, tile = st % tiles;
    const int g = blockIdx.x + wi * gridDim.x, hl = a.hp == h ? hh : 0;
    cp_async_wait<0>();
    __syncthreads();

    // 1. q, k, v of head hh for the tile's 64 tokens, 16 a warp: x w on
    // tensor cores, then the fp32 bias, the unit norm (q, k), q's scale,
    // rounded to bf16 into shared memory
#pragma unroll 1
    for (int p = 0; p < 3; ++p) {
      float acc[NTL][4];
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const bf16* wp = wsm + (size_t)(hl * 3 + p) * DP * L.ldw;
      for (int kk = 0; kk < Cp / 16; ++kk) {
        unsigned af[4];
        ldmatrix_x4(af, xs + (warp * 16 + (mi & 1) * 8 + lane % 8) * L.ldw + kk * 16 +
                            (mi >> 1) * 8);
#pragma unroll
        for (int n = 0; n < NTL; n += 2) {
          unsigned bfr[4];
          ldmatrix_x4(bfr, wp + (n * 8 + (mi >> 1) * 8 + lane % 8) * L.ldw + kk * 16 +
                               (mi & 1) * 8);
          mma_bf16(acc[n], af, bfr[0], bfr[1]);
          mma_bf16(acc[n + 1], af, bfr[2], bfr[3]);
        }
      }
      const float* bb = bsm + (hl * 3 + p) * DP;
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += bb[n * 8 + 2 * qd + (e & 1)];
      if (p < 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ss = 0.f;
#pragma unroll
          for (int n = 0; n < NTL; ++n) {
            ss = fmaf(acc[n][2 * r], acc[n][2 * r], ss);
            ss = fmaf(acc[n][2 * r + 1], acc[n][2 * r + 1], ss);
          }
          const float inv = rsqrtf(fmaxf(quad_sum(ss), 1e-24f));
#pragma unroll
          for (int n = 0; n < NTL; ++n) {
            acc[n][2 * r] *= inv;
            acc[n][2 * r + 1] *= inv;
          }
        }
      }
      if (p == 0) {
        const float sc = a.scale[hh];
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= sc;
      }
      bf16* dst = p == 0 ? qs : p == 1 ? ks : vs;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = tile * 64 + warp * 16 + gr + 8 * r;
#pragma unroll
        for (int n = 0; n < NTL; ++n)
          *reinterpret_cast<unsigned*>(dst + t * L.ldq + n * 8 + 2 * qd) =
              pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    __syncthreads();  // x and w consumed, the tile's q, k, v complete
    if (st + 1 < steps) issue(st + 1);
    if (tile < tiles - 1) continue;

    // 2. attention of head hh, 16 query rows a warp, keys in chunks of 64
    const float* biash = a.bias + (size_t)hh * N * N;
    const int* bw = a.bands ? bnd + (wi & 1) * L.NT : nullptr;
    const int nch = tiles;
    for (int rt = warp; rt < rtiles; rt += kMmaThreads / 32) {
      unsigned qa[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qa[kk], qs + (rt * 16 + (mi & 1) * 8 + lane % 8) * L.ldq + kk * 16 +
                                (mi >> 1) * 8);
      const int rows[2] = {rt * 16 + gr, rt * 16 + gr + 8};
      int bq[2] = {0, 0};
      if (bw) {
        bq[0] = bw[rows[0]];
        bq[1] = bw[rows[1]];
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mL[2], inv_l[2];
      float s[8][4], o[NTL][4];
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
      auto logits = [&](int c) {
        const int nk = min(kMmaKeys, N - c * kMmaKeys);
        const float* br[2] = {rows[0] < N ? biash + (size_t)rows[0] * N + c * kMmaKeys : nullptr,
                              rows[1] < N ? biash + (size_t)rows[1] * N + c * kMmaKeys : nullptr};
        float bv[8][4];
        load_bias_f32(bv, br, nk, lane);
        chunk_qk(qa, ks + c * kMmaKeys * L.ldq, nk, lane, s);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += bv[j][e];
        mask_logits(s, bw ? bw + c * kMmaKeys : nullptr, bq, nk, lane);
      };
      for (int c = 0; c < nch; ++c) {
        logits(c);
        fold_rows(s, m, l);
      }
      finish_rows(m, l, mL, inv_l);
      for (int c = 0; c < nch; ++c) {
        if (nch > 1) logits(c);  // one chunk: its logits are still in s
        exp_times_v<true>(s, mL, inv_l, vs + c * kMmaKeys * L.ldq, N - c * kMmaKeys, lane, o);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        bf16* out = a.y + (size_t)out_reg.pixel(g, rows[r]) * a.Cw + hh * d;
#pragma unroll
        for (int n = 0; n < NTL; ++n) {
          const int col = n * 8 + 2 * qd;
          const float y0 = o[n][2 * r] * inv_l[r], y1 = o[n][2 * r + 1] * inv_l[r];
          if (d % 2 == 0 && col + 1 < d) {
            *reinterpret_cast<unsigned*>(out + col) = pack_bf16(y0, y1);
          } else {
            if (col < d) out[col] = __float2bfloat16(y0);
            if (col + 1 < d) out[col + 1] = __float2bfloat16(y1);
          }
        }
      }
    }
  }
}

template <int DP>
int launch_window_half_mma(WinMmaArgs a, cudaStream_t stream) {
  auto kernel = window_half_mma_kernel<DP>;
  const int N = a.wh * a.ww;
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every head's w resident for the block's whole walk, or one head's at a
  // time when that does not fit
  a.hp = a.heads;
  size_t bytes = WinLayout<DP>(a.Cp, N, a.hp).bytes;
  if (bytes > static_cast<size_t>(limit)) {
    a.hp = 1;
    bytes = WinLayout<DP>(a.Cp, N, a.hp).bytes;
  }
  const int e = set_smem(kernel, bytes);
  if (e) return e;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nwin = (long long)a.B * (a.H / a.wh) * (a.W / a.ww);
  const long long blocks = std::min<long long>(nwin, (long long)std::max(per_sm, 1) * sms);
  if (blocks <= 0) return 0;
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace grlir

// fp32 on CUDA cores.  x (B, H, W, C) unrolled; w (C, 3Cw); bqkv (3Cw,);
// scale (heads,); bias (heads, N, N); all fp32; bands (windows, N) int32 or
// null; y (B, H, W, Cw) fp32.  Returns 0 on success, -1 when the window does
// not fit in shared memory, or the cudaError_t of a failed launch.
extern "C" int grlir_window_half(const void* x, const void* w, const float* bqkv,
                                 const float* scale, const float* bias, const int* bands,
                                 void* y, int B, int H, int W, int C, int Cw, int heads,
                                 int wh, int ww, int shift, void* stream) {
  return grlir::launch_window_half<float>(x, w, bqkv, scale, bias, bands, y, B, H, W, C,
                                          Cw, heads, wh, ww, shift,
                                          static_cast<cudaStream_t>(stream));
}

// bf16 on tensor cores.  x (B, H, W, C) bf16 unrolled; w (C, 3Cw) fp32
// (w_bf16 0) or bf16 (1), element strides w_sc over input channels and
// w_scol over columns; bqkv (3Cw,) fp32; scale (heads,) fp32; bias (heads,
// N, N) fp32; bands (windows, N) int32 or null; y (B, H, W, Cw) bf16.
// Returns 0, -1 (head dim above 64 or shared memory) or a cudaError_t.
extern "C" int grlir_window_half_mma(const void* x, const void* w, long long w_sc,
                                     long long w_scol, int w_bf16, const float* bqkv,
                                     const float* scale, const float* bias, const int* bands,
                                     void* y, int B, int H, int W, int C, int Cw, int heads,
                                     int wh, int ww, int shift, void* stream) {
  const int d = Cw / heads;
  const grlir::WinMmaArgs a{static_cast<const grlir::bf16*>(x), w, w_sc, w_scol, w_bf16, bqkv,
                            scale, bias, bands, static_cast<grlir::bf16*>(y), B, H, W, C,
                            (C + 15) / 16 * 16, Cw, heads, d, wh, ww, shift, heads};
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return grlir::launch_window_half_mma<32>(a, s);
  if (d <= 64) return grlir::launch_window_half_mma<64>(a, s);
  return -1;
}

extern "C" const char* grlir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
