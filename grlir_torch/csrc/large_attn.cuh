// Building blocks of the large-geometry block-half kernels (B3 in
// window_half_large.cu, B4's fp32 route in stripe_half_large.cu, whose bf16
// route runs on tensor cores, stripe_attn_mma.cuh); flash_attention.cu (B5)
// runs the same attention kernel on operands projected beforehand.
//
// At GRL-base's eval geometry a window holds 1024 tokens and a stripe 4096
// or 8192, so one attention no longer fits a block's 227 KB of shared
// memory the way B1/B2 keep it.  Each half therefore runs as three kernels
// on one stream:
//
//   project_regions_kernel  x tiles of 64 tokens -> q/k/v of every head,
//                           unit-normed (q times the logit scale where the
//                           TPU folds it in) and rounded to the input type,
//                           into a workspace [region][head][part][token][d];
//   anchor_units_kernel     anchor tokens -> unit-normed, rounded, into a
//                           workspace [region][head][token][d];
//   attend_kernel           one block per (region, head, 32 query rows):
//                           keys and values stream through shared memory in
//                           chunks of 128 from the workspace (L2-resident),
//                           in two passes.  Pass 1 takes each row's max and
//                           sum over all keys; pass 2 recomputes the logits,
//                           forms the probabilities exactly as the TPU does
//                           (exp(s - max) rounded, times 1/sum after the
//                           product for B3; exp(s - max) / sum rounded before
//                           it for B4) and multiplies them by v.
//
// The two passes cost a third more logit FMAs than one, and buy the TPU's
// rounding points exactly: no online rescaling of rounded probabilities.
// Every block spreads its 32 query rows over the lanes of a warp (each lane
// holds its q row in registers) and its keys over the 8 warps, so a logit is
// 32 register FMAs against 8 broadcast float4 loads of the key, and the
// product with v is the same shape.  Head dims up to 64, zero-padded to DP =
// 32 or 64 columns (`head_cols`).
#pragma once

#include "common.cuh"

namespace grlir {
namespace {

constexpr int kMaxD = 64;   // widest head dim the kernels take
constexpr int kRows = 32;   // query rows per attention block: one per lane
constexpr int kKeys = 128;  // keys staged per chunk
constexpr int kLds = kKeys + 1;

// Columns a head's rows are padded to: 32, or 64 above 32.
inline int head_cols(int d) { return d <= 32 ? 32 : 64; }

// floats of shared memory of attend_kernel<DP>: key and value chunks (reused
// for the cross-warp sum), logits of the chunk, row max and sum
template <int DP>
constexpr int attend_smem_floats() {
  return 2 * kKeys * DP + kRows * kLds + 2 * kRows;
}
static_assert(kWarps * kRows <= 2 * kKeys, "reduction buffer");

// The most dynamic shared memory one block can have, in *limit; returns 0 or
// a cudaError_t.
inline int smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// Set a kernel's dynamic shared memory, or return -1 when one block cannot
// have that much.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err) return err;
  if (bytes > static_cast<size_t>(limit)) return -1;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)));
}

// Tokens of region g: the (rh, rw) regions tile the image rolled by
// (shift_h, shift_w) row-major, B images after one another; token t of a
// region sits at row t / rw, column t % rw of it.
struct Regions {
  int H, W, rh, rw, shift_h, shift_w;
  __device__ int count() const { return (H / rh) * (W / rw); }
  // pixel index (b * H + y) * W + x in the unrolled image
  __device__ int pixel(int g, int t) const {
    const int n = count(), b = g / n, r = g % n, nx = W / rw;
    const int y = ((r / nx) * rh + t / rw + shift_h) % H;
    const int x = ((r % nx) * rw + t % rw + shift_w) % W;
    return (b * H + y) * W + x;
  }
};

// ws[g][head][p][t][e] = part p0 + p (q, k, v = 0, 1, 2) of head `head` of
// token t of region g: x . w[:, part columns] + b, unit-normed for the
// parts set in norm_mask (part 0 also times scale[head] when scale is
// given), rounded to T.  w is this half's (C, 3 Cx) projection.  Grid
// (regions * B, ceil(N / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
project_regions_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bqkv, const float* __restrict__ scale,
                       T* __restrict__ ws, Regions reg, int C, int Cx, int heads, int p0,
                       int nparts, int norm_mask) {
  const int d = Cx / heads, N = reg.rh * reg.rw, ncols = nparts * Cx, ldt = ncols + 1;
  const int g = blockIdx.x, t0 = blockIdx.y * kTileRows, nt = min(kTileRows, N - t0);
  extern __shared__ float smem[];
  int* pix = reinterpret_cast<int*>(smem);  // [kTileRows]
  int* cols = pix + kTileRows;              // [ncols]
  float* scratch = smem + kTileRows + ncols;
  float* tile = scratch + kProjScratch;     // [kTileRows][ldt]

  for (int j = threadIdx.x; j < ncols; j += kThreads) cols[j] = p0 * Cx + j;
  for (int i = threadIdx.x; i < nt; i += kThreads) pix[i] = reg.pixel(g, t0 + i);
  __syncthreads();
  project_tile<T>(x, pix, nt, C, w, 3 * Cx, bqkv, cols, ncols, scratch, tile, ldt);
  for (int p = 0; p < nparts; ++p) {
    if (!(norm_mask >> p & 1)) continue;
    for (int hh = 0; hh < heads; ++hh)
      normalize_rows<T>(tile + p * Cx + hh * d, nt, d, ldt,
                        (p == 0 && scale) ? scale[hh] : 1.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nparts * heads * nt * d; i += kThreads) {
    const int e = i % d, t = (i / d) % nt, ph = i / (d * nt);
    const int p = ph / heads, hh = ph % heads;
    ws[((((size_t)g * heads + hh) * nparts + p) * N + t0 + t) * d + e] =
        from_f<T>(tile[t * ldt + p * Cx + hh * d + e]);
  }
}

// an[g][head][a][e] = anchor token a of region g (anchor regions (ah, aw)
// tile the (Ha, Wa) anchor map, which the caller has rolled), unit-normed
// and rounded to T, in rows of ld >= d elements (zeros past d).  One warp
// per token, lanes e and e + 32 take channels e and e + 32 (d, ld <= 64).
// Grid (regions * B, heads,
// token groups): block z takes tokens z * kWarps + warp, every gridDim.z *
// kWarps.
template <typename T>
__global__ void __launch_bounds__(kThreads)
anchor_units_kernel(const T* __restrict__ anchor, T* __restrict__ an, int Ha, int Wa, int Cs,
                    int heads, int ah, int aw, int ld) {
  const Regions reg{Ha, Wa, ah, aw, 0, 0};
  const int d = Cs / heads, Na = ah * aw, g = blockIdx.x, hh = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int a = blockIdx.z * kWarps + warp; a < Na; a += gridDim.z * kWarps) {
    const size_t p = reg.pixel(g, a);
    float v[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < d ? to_f(anchor[p * Cs + hh * d + e]) : 0.f;
    }
    const float inv = rsqrtf(fmaxf(warp_sum(fmaf(v[1], v[1], v[0] * v[0])), 1e-24f));
    T* row = an + (((size_t)g * heads + hh) * Na + a) * ld;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i)
      if (lane + 32 * i < ld) row[lane + 32 * i] = from_f<T>(v[i] * inv);
  }
}

// Operands of attend_kernel.  q, k, v: [g * heads + head] blocks of
// (Nq|Nk, d) rows in T, the given number of elements apart.  bias:
// (heads, Nq, Nk).  band_q/band_k: (regions per image, Nq|Nk) shift-band
// ids, or null.  out: NHWC (B, H, W, heads * d) at the tokens of (rh, rw)
// regions when rw > 0 (rolled coordinates), else [g][head][d][Nq] when
// out_cm is set (channel-major, B5), else [g][head][Nq][d].
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_stride, k_stride, v_stride;
  int Nq, Nk, d, heads, regions;
  const float* scale;
  const void* bias;
  const int* band_q;
  const int* band_k;
  void* out;
  int H, W, rh, rw, out_cm;
};

// y = softmax(q . k^T * scale + bias + mask) v for 32 query rows of one
// (region, head); see the note at the top.  kDeferred: B3's numerics (the
// exps rounded, 1/sum applied to the product), else B4's (probabilities
// normalised, then rounded).  DP: the head's columns in registers and shared
// memory (32 or 64, zeros past d).  Grid (ceil(Nq / 32), regions * B *
// heads).
template <typename T, typename BT, bool kDeferred, int DP>
__global__ void __launch_bounds__(kThreads)
attend_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  float* kc = smem;                   // [kKeys][DP]
  float* vc = kc + kKeys * DP;        // [kKeys][DP]
  float* sc = vc + kKeys * DP;        // [kRows][kLds]
  float* mrow = sc + kRows * kLds;    // [kRows] running max
  float* lrow = mrow + kRows;         // [kRows] running sum
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gh = blockIdx.y, g = gh / a.heads, hh = gh % a.heads;
  const int row0 = blockIdx.x * kRows, d = a.d;
  const T* qp = static_cast<const T*>(a.q) + gh * a.q_stride;
  const T* kp = static_cast<const T*>(a.k) + gh * a.k_stride;
  const T* vp = static_cast<const T*>(a.v) + gh * a.v_stride;
  const BT* bias = static_cast<const BT*>(a.bias) + (size_t)hh * a.Nq * a.Nk;
  const int* bq = a.band_q ? a.band_q + (size_t)(g % a.regions) * a.Nq : nullptr;
  const int* bk = a.band_k ? a.band_k + (size_t)(g % a.regions) * a.Nk : nullptr;
  const float scale = a.scale ? a.scale[hh] : 1.f;

  float q[DP], acc[DP];
  const int r = row0 + lane;
#pragma unroll
  for (int e = 0; e < DP; ++e) {
    q[e] = (r < a.Nq && e < d) ? to_f(qp[(size_t)r * d + e]) : 0.f;
    acc[e] = 0.f;
  }
  if (threadIdx.x < kRows) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < a.Nk; c0 += kKeys) {
      const int nk = min(kKeys, a.Nk - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < kKeys * DP; i += kThreads) {
        const int kk = i / DP, e = i % DP;
        const bool in = kk < nk && e < d;
        kc[i] = in ? to_f(kp[(size_t)(c0 + kk) * d + e]) : 0.f;
        if (pass) vc[i] = in ? to_f(vp[(size_t)(c0 + kk) * d + e]) : 0.f;
      }
      __syncthreads();
      // logits q . k: lane = query row, warps take the keys in turn
      for (int kk = warp; kk < nk; kk += kWarps) {
        const float4* k4 = reinterpret_cast<const float4*>(kc + kk * DP);
        float s = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < DP / 4; ++e4) {
          const float4 kv = k4[e4];
          s = fmaf(q[4 * e4], kv.x, s);
          s = fmaf(q[4 * e4 + 1], kv.y, s);
          s = fmaf(q[4 * e4 + 2], kv.z, s);
          s = fmaf(q[4 * e4 + 3], kv.w, s);
        }
        sc[lane * kLds + kk] = s;
      }
      __syncthreads();
      // scale, bias and mask, one warp per row: pass 1 folds the chunk into
      // the row's max and sum, pass 2 turns logits into probabilities
      for (int rr = warp; rr < kRows; rr += kWarps) {
        const int row = row0 + rr;
        if (row >= a.Nq) continue;
        float* srow = sc + rr * kLds;
        const BT* brow = bias + (size_t)row * a.Nk + c0;
        const int bqr = bq ? bq[row] : 0;
        if (pass == 0) {
          float mx = -INFINITY;
          for (int kk = lane; kk < nk; kk += 32) {
            float s = __fadd_rn(__fmul_rn(srow[kk], scale), to_f(brow[kk]));
            if (bk && bk[c0 + kk] != bqr) s += -100.f;
            srow[kk] = s;
            mx = fmaxf(mx, s);
          }
          const float m_old = mrow[rr];
          const float m_new = fmaxf(m_old, warp_max(mx));
          float sum = 0.f;
          for (int kk = lane; kk < nk; kk += 32) sum += expf(srow[kk] - m_new);
          sum = warp_sum(sum);
          if (lane == 0) {
            lrow[rr] = fmaf(lrow[rr], expf(m_old - m_new), sum);
            mrow[rr] = m_new;
          }
        } else {
          const float m = mrow[rr], l = lrow[rr];
          for (int kk = lane; kk < nk; kk += 32) {
            float s = __fadd_rn(__fmul_rn(srow[kk], scale), to_f(brow[kk]));
            if (bk && bk[c0 + kk] != bqr) s += -100.f;
            const float e = expf(s - m);
            srow[kk] = round_mm<T>(kDeferred ? e : e / l);
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // probabilities times v: lane = query row, warps take the keys in turn
      for (int kk = warp; kk < nk; kk += kWarps) {
        const float p = sc[lane * kLds + kk];
        const float4* v4 = reinterpret_cast<const float4*>(vc + kk * DP);
#pragma unroll
        for (int e4 = 0; e4 < DP / 4; ++e4) {
          const float4 vv = v4[e4];
          acc[4 * e4] = fmaf(p, vv.x, acc[4 * e4]);
          acc[4 * e4 + 1] = fmaf(p, vv.y, acc[4 * e4 + 1]);
          acc[4 * e4 + 2] = fmaf(p, vv.z, acc[4 * e4 + 2]);
          acc[4 * e4 + 3] = fmaf(p, vv.w, acc[4 * e4 + 3]);
        }
      }
    }
  }

  // sum the warps' partial products (red[warp][e][row] over the chunks)
  __syncthreads();
  float* red = kc;
#pragma unroll
  for (int e = 0; e < DP; ++e) red[(warp * DP + e) * kRows + lane] = acc[e];
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    // neighbouring threads write neighbouring addresses in either layout
    const int rr = a.out_cm ? i % kRows : i / d, e = a.out_cm ? i / kRows : i % d;
    const int row = row0 + rr;
    if (row >= a.Nq) continue;
    float y = 0.f;
    for (int w = 0; w < kWarps; ++w) y += red[(w * DP + e) * kRows + rr];
    if (kDeferred) y *= 1.f / lrow[rr];
    size_t o;
    if (a.rw > 0) {
      const Regions reg{a.H, a.W, a.rh, a.rw, 0, 0};
      o = (size_t)reg.pixel(g, row) * (a.heads * d) + hh * d + e;
    } else if (a.out_cm) {
      o = ((size_t)gh * d + e) * a.Nq + row;
    } else {
      o = ((size_t)gh * a.Nq + row) * d + e;
    }
    out[o] = from_f<T>(y);
  }
}

template <typename T, typename BT, bool kDeferred, int DP>
int launch_attend_cols(const AttnArgs& a, int groups, cudaStream_t stream) {
  auto kernel = attend_kernel<T, BT, kDeferred, DP>;
  const size_t smem = sizeof(float) * attend_smem_floats<DP>();
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((a.Nq + kRows - 1) / kRows, groups * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch attend_kernel at a.d's padded width; returns 0, -1 (d > 64 or
// shared memory) or a cudaError_t.
template <typename T, typename BT, bool kDeferred>
int launch_attend(const AttnArgs& a, int groups, cudaStream_t stream) {
  if (a.d > kMaxD) return -1;
  if (a.d <= 32) return launch_attend_cols<T, BT, kDeferred, 32>(a, groups, stream);
  return launch_attend_cols<T, BT, kDeferred, 64>(a, groups, stream);
}

// Launch project_regions_kernel; returns 0, -1 or a cudaError_t.
template <typename T>
int launch_project(const void* x, const void* w, const float* bqkv, const float* scale,
                   void* ws, const Regions& reg, int B, int C, int Cx, int heads, int p0,
                   int nparts, int norm_mask, cudaStream_t stream) {
  auto kernel = project_regions_kernel<T>;
  const int ncols = nparts * Cx, N = reg.rh * reg.rw;
  const size_t smem =
      sizeof(float) * (kTileRows + ncols + kProjScratch + kTileRows * (ncols + 1));
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const int regions = (reg.H / reg.rh) * (reg.W / reg.rw);
  const dim3 grid(B * regions, (N + kTileRows - 1) / kTileRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bqkv, scale, static_cast<T*>(ws),
      reg, C, Cx, heads, p0, nparts, norm_mask);
  return static_cast<int>(cudaGetLastError());
}

// Launch anchor_units_kernel; returns 0 or a cudaError_t.
template <typename T>
int launch_anchor_units(const void* anchor, void* an, int B, int Ha, int Wa, int Cs, int heads,
                        int ah, int aw, int ld, cudaStream_t stream) {
  // about four tokens a warp
  const int groups = (ah * aw + 4 * kWarps - 1) / (4 * kWarps);
  const dim3 grid(B * (Ha / ah) * (Wa / aw), heads, groups < 65535 ? groups : 65535);
  anchor_units_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(anchor), static_cast<T*>(an), Ha, Wa, Cs, heads, ah, aw, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace grlir
