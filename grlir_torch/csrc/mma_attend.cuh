// mma_attend_kernel: the one-pass tensor-core attention of the bf16 routes of
// B3 (window_half_large.cu), B4 (stripe_half_large.cu) and B5
// (flash_attention.cu), on stripe_attn_mma.cuh's workspace rows; its design,
// numerics and bound are in the note at the top of stripe_attn_mma.cuh.
#pragma once

#include <stdint.h>

#include "stripe_attn_mma.cuh"

namespace grlir {
namespace {

// chunks of keys in shared memory: one computed, the next in flight
constexpr int kAttendStages = 2;

// Shared memory of mma_attend_kernel<DP, WARPS> (16 query rows a warp): the
// q tile, then kAttendStages stages of k, v and the key band ids.  Blocks an
// SM holds: 65536 registers over 128 a thread (two of 8 warps, four of 4).
template <int DP, int WARPS>
struct AttendSmem {
  static constexpr int kRows = 16 * WARPS;
  static constexpr int kStage = 2 * kMmaKeys * ld_k<DP>() * 2 + kMmaKeys * 4;
  static constexpr int kQ = kRows * ld_k<DP>() * 2;
  static constexpr int kBytes = kQ + kAttendStages * kStage;
  static constexpr int kMinBlocks = 65536 / (32 * WARPS * 128);
  static_assert(kStage % 16 == 0 && kQ % 16 == 0, "16-byte aligned stages");
  static_assert(kRows * (DP + 1) * 4 + kRows * 4 <= kAttendStages * kStage + kQ,
                "output staging fits the q tile and the stages");
  static_assert(kMinBlocks * (kBytes + 1024) <= 233472, "the blocks fit an SM");
};

// The key of a chunk in column n (0..7) of key tile j (0..7) of the logits'
// accumulators: thread lane % 4 == qd then holds keys 16 qd .. 16 qd + 15
// of each of its rows, in order (tile j, column 2 qd + b: key 16 qd + 2 j +
// b), so its bias values are 32 contiguous bytes.  k and v rows are stored
// in shared memory in the order of the mma (row 8 j + n holds this key), so
// their fragments load as for keys in order.
__device__ __forceinline__ int mma_key(int j, int n) { return 16 * (n >> 1) + 2 * j + (n & 1); }

// y = softmax(q . k^T * scale + bias + mask) v for 16 WARPS query rows of
// one (region, head), in one pass over the keys; see the note at the top of
// stripe_attn_mma.cuh.  a.q, a.k, a.v: rows of DP bf16, zero past d;
// a.bias: (heads, Nq, Nk) bf16.  bias_vec: the bias rows are 16-byte
// aligned (Nk % 8 == 0), else element loads.  Grid (groups * ceil(Nq /
// rows) * heads), the region fastest.
template <int DP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, (AttendSmem<DP, WARPS>::kMinBlocks))
mma_attend_kernel(AttnArgs a, int groups, int bias_vec) {
  using Smem = AttendSmem<DP, WARPS>;
  constexpr int kRows = Smem::kRows, kThreadsA = 32 * WARPS, kLdK = ld_k<DP>();
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int tiles = (a.Nq + kRows - 1) / kRows;
  const int g = blockIdx.x % groups, rest = blockIdx.x / groups;
  const int row0 = (rest % tiles) * kRows, hh = rest / tiles;
  const long long gh = (long long)g * a.heads + hh;
  const bf16* qp = static_cast<const bf16*>(a.q) + gh * a.q_stride;
  const bf16* kp = static_cast<const bf16*>(a.k) + gh * a.k_stride;
  const bf16* vp = static_cast<const bf16*>(a.v) + gh * a.v_stride;
  const bf16* bias = static_cast<const bf16*>(a.bias) + (size_t)hh * a.Nq * a.Nk;
  const int* bq = a.band_q ? a.band_q + (size_t)(g % a.regions) * a.Nq : nullptr;
  const int* bkg = a.band_k ? a.band_k + (size_t)(g % a.regions) * a.Nk : nullptr;
  const float scale = a.scale ? a.scale[hh] : 1.f;
  const int nch = (a.Nk + kMmaKeys - 1) / kMmaKeys;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gr = lane / 4, qd = lane % 4, mi = lane / 8;

  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [kRows][kLdK]
  unsigned char* stages = mma_smem + Smem::kQ;

  // stage layout: k [64][kLdK], v [64][kLdK] (row 8 j + n: key mma_key(j,
  // n)), band ids [64] (in key order).  Each thread copies the same kPer
  // 16-byte pieces of k and of v every chunk: their key in the chunk,
  // column and place in the stage are worked out once
  constexpr int kPieces = kMmaKeys * (DP / 8), kPer = kPieces / kThreadsA;
  static_assert(kPieces % kThreadsA == 0, "whole pieces a thread");
  int pkey[kPer], pcol[kPer], pdst[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreadsA, r = i / (DP / 8);
    pkey[u] = mma_key(r / 8, r % 8);
    pcol[u] = (i % (DP / 8)) * 8;
    pdst[u] = r * kLdK + pcol[u];
  }
  auto load = [&](int c) {
    const int c0 = c * kMmaKeys;
    bf16* ks = reinterpret_cast<bf16*>(stages + (c % kAttendStages) * Smem::kStage);
    bf16* vs = ks + kMmaKeys * kLdK;
    int* bks = reinterpret_cast<int*>(vs + kMmaKeys * kLdK);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int key = c0 + pkey[u];
      const bool ok = key < a.Nk;
      const size_t off = (size_t)(ok ? key : 0) * DP + pcol[u];
      cp_async16(ks + pdst[u], kp + off, ok);
      cp_async16(vs + pdst[u], vp + off, ok);
    }
    if (bkg && tid < kMmaKeys) {
      const bool ok = c0 + tid < a.Nk;
      cp_async4(bks + tid, ok ? bkg + c0 + tid : bkg, ok);
    }
  };

  for (int i = tid; i < kRows * (DP / 8); i += kThreadsA) {
    const int r = i / (DP / 8), cc = (i % (DP / 8)) * 8;
    const bool ok = row0 + r < a.Nq;
    cp_async16(qs + r * kLdK + cc, qp + (size_t)(ok ? row0 + r : 0) * DP + cc, ok);
  }
  for (int c = 0; c < kAttendStages - 1; ++c) {  // the q tile joins the first group
    if (c < nch) load(c);
    cp_async_commit();
  }

  // this thread's rows (of the block): r0 = 16 warp + lane / 4 and r0 + 8
  const int r0 = warp * 16 + gr;
  int bqr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    bqr[r] = bq && row < a.Nq ? bq[row] : 0;
  }
  // this thread's bias values of chunk c: its rows r, keys c0 + 16 qd .. c0
  // + 16 qd + 15 as bf16 pairs, zeros past Nq and Nk.  With bias_vec (Nk a
  // multiple of 8) each half of 8 keys is wholly in or out
  unsigned bb[2][8];
  const bf16* brow[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    rok[r] = row < a.Nq;
    brow[r] = bias + (size_t)(rok[r] ? row : 0) * a.Nk;
  }
  auto load_bias = [&](int c) {
    const int key0 = c * kMmaKeys + 16 * qd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool row_ok = rok[r];
      const bf16* br = brow[r];
      if (bias_vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = key0 + 8 * h;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row_ok && key < a.Nk) v = __ldg(reinterpret_cast<const uint4*>(br + key));
          bb[r][4 * h] = v.x;
          bb[r][4 * h + 1] = v.y;
          bb[r][4 * h + 2] = v.z;
          bb[r][4 * h + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int key = key0 + 2 * u;
          const bf16 lo = row_ok && key < a.Nk ? br[key] : __float2bfloat16(0.f);
          const bf16 hi = row_ok && key + 1 < a.Nk ? br[key + 1] : __float2bfloat16(0.f);
          bb[r][u] = pack_bf16(__bfloat162float(lo), __bfloat162float(hi));
        }
      }
    }
  };
  load_bias(0);
  unsigned qa[DP / 16][4];
  // the rows' running max (the same in the four lanes of a quad) and this
  // thread's share of their sums, both against that max
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int c = 0; c < nch; ++c) {
    // chunk c has landed, and every warp is done with chunk c - 1, whose
    // stage the next load refills
    cp_async_wait<kAttendStages - 2>();
    __syncthreads();
    if (c + kAttendStages - 1 < nch) load(c + kAttendStages - 1);
    cp_async_commit();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * kLdK + kk * 16 +
                                (mi >> 1) * 8);
    }
    const int nk = a.Nk - c * kMmaKeys;
    const bf16* ks = reinterpret_cast<const bf16*>(stages + (c % kAttendStages) * Smem::kStage);
    const bf16* vs = ks + kMmaKeys * kLdK;
    const int* bks = reinterpret_cast<const int*>(vs + kMmaKeys * kLdK);

    // logits of this warp's 16 rows against the chunk's 64 keys; the
    // products run over the whole chunk (its rows past Nk are zero-filled),
    // so the loops carry no branch on nk
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; kk += 2) {
        unsigned b[4];
        ldmatrix_x4(b, ks + (j * 8 + lane % 8) * kLdK + kk * 16 + mi * 8);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j], qa[kk + 1], b[2], b[3]);
      }
    }
    // fl(fl(acc * scale) + bias) (B3 folds its scale into q and multiplies
    // by nothing); then the next chunk's bias is loaded into the same
    // registers, its trip to L2 hidden behind the rest of this chunk
    if (a.scale) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&bb[r][j]);
        s[j][2 * r] = __fadd_rn(s[j][2 * r], __low2float(b2));
        s[j][2 * r + 1] = __fadd_rn(s[j][2 * r + 1], __high2float(b2));
      }
    if (c + 1 < nch) load_bias(c + 1);
    // -100 where the key's band id differs from the row's; keys past Nk
    // drop out
    if (bkg) {
      int bk[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int4 b4 = *reinterpret_cast<const int4*>(bks + 16 * qd + 4 * u);
        bk[4 * u] = b4.x;
        bk[4 * u + 1] = b4.y;
        bk[4 * u + 2] = b4.z;
        bk[4 * u + 3] = b4.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (bk[2 * j + (e & 1)] != bqr[e >> 1]) s[j][e] += -100.f;
    }
    if (nk < kMmaKeys) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (16 * qd + 2 * j + (e & 1) >= nk) s[j][e] = -INFINITY;
    }

    // the rows' max over the keys so far (every chunk holds a key below
    // Nk, so it is finite); where it rose in any row of the warp, o and l
    // are rescaled by 2^((m_old - m_new) log2 e): 0 on the first chunk, 1
    // for a row whose max held
    float m_new[2], mL[2];
    bool rose = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      m_new[r] = fmaxf(m[r], quad_max(mx));
      rose |= m_new[r] > m[r];
      mL[r] = m_new[r] * kLog2e;
    }
    if (__any_sync(0xffffffffu, rose)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = ex2((m[r] - m_new[r]) * kLog2e);
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
        m[r] = m_new[r];
      }
    }

    // p = bf16(exp(s - m)), summed unrounded into l, in the A-fragment
    // layout of P v (key tiles 2k, 2k + 1 make k-step k)
    unsigned pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[j][e], kLog2e, -mL[e >> 1]));
        l[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // o += p v (v rows past Nk are zero-filled, their p 0)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + (mi & 1) * 8 + lane % 8) * kLdK + n * 8 +
                                 (mi >> 1) * 8);
        mma_bf16(o[n], pa[kk], b[0], b[1]);
        mma_bf16(o[n + 1], pa[kk], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the shared memory the output reuses

  // y = o / l: stage the output tile in shared memory, then write it in the
  // caller's layout with neighbouring threads on neighbouring addresses
  float* os = reinterpret_cast<float*>(mma_smem);              // [kRows][DP + 1]
  int* opix = reinterpret_cast<int*>(os + kRows * (DP + 1));  // [kRows]: NHWC pixels
  if (a.rw > 0 && tid < kRows) {
    const Regions reg{a.H, a.W, a.rh, a.rw, 0, 0};
    opix[tid] = row0 + tid < a.Nq ? reg.pixel(g, row0 + tid) : 0;
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      os[(r0 + 8 * (e >> 1)) * (DP + 1) + n * 8 + 2 * qd + (e & 1)] = o[n][e] * inv_l[e >> 1];
  __syncthreads();
  const int d = a.d;
  bf16* out = static_cast<bf16*>(a.out);
  for (int i = tid; i < kRows * d; i += kThreadsA) {
    const int rr = a.out_cm ? i % kRows : i / d, e = a.out_cm ? i / kRows : i % d;
    const int row = row0 + rr;
    if (row >= a.Nq) continue;
    size_t off;
    if (a.rw > 0) {
      off = (size_t)opix[rr] * (a.heads * d) + hh * d + e;
    } else if (a.out_cm) {
      off = ((size_t)gh * d + e) * a.Nq + row;
    } else {
      off = ((size_t)gh * a.Nq + row) * d + e;
    }
    out[off] = __float2bfloat16(os[rr * (DP + 1) + e]);
  }
}

// The card's resident-block slots for mma_attend_kernel<DP, WARPS> (its SMs
// times the blocks an SM holds at once), with its shared memory set; 0 on
// an error, which *err holds.
template <int DP, int WARPS>
long long attend_slots(int* err) {
  auto kernel = mma_attend_kernel<DP, WARPS>;
  constexpr int kBytes = AttendSmem<DP, WARPS>::kBytes;
  int dev = 0, sms = 0, per_sm = 0;
  *err = set_smem(kernel, kBytes);
  if (*err) return 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * WARPS, kBytes);
  *err = static_cast<int>(e);
  return e == cudaSuccess ? (long long)sms * per_sm : 0;
}

// Query rows a block of mma_attend_kernel takes for this grid: 128 (8
// warps) where the grid of 128-row blocks fills every resident slot of the
// card, else 64 (4 warps), so a small grid keeps its SMs busy.  It depends
// only on the shape (groups x Nq x heads, and d through DP) and the card.
// Returns 64 or 128, or 0 on an error, which *err holds.
template <int DP>
int attend_rows_cols(long long Nq, long long groups, int heads, int* err) {
  const long long slots = attend_slots<DP, 8>(err);
  if (*err) return 0;
  return groups * ((Nq + 127) / 128) * heads >= slots ? 128 : 64;
}

int attend_rows(long long Nq, long long groups, int heads, int d, int* err) {
  *err = 0;
  if (d > kMaxD) {
    *err = -1;
    return 0;
  }
  return d <= 32 ? attend_rows_cols<32>(Nq, groups, heads, err)
                 : attend_rows_cols<64>(Nq, groups, heads, err);
}

template <int DP, int WARPS>
int launch_mma_attend_rows(const AttnArgs& a, int groups, cudaStream_t stream) {
  auto kernel = mma_attend_kernel<DP, WARPS>;
  constexpr int kBytes = AttendSmem<DP, WARPS>::kBytes, kRows = 16 * WARPS;
  const int err = set_smem(kernel, kBytes);
  if (err) return err;
  const int bias_vec =
      a.Nk % 8 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0 ? 1 : 0;
  const long long blocks = (long long)groups * ((a.Nq + kRows - 1) / kRows) * a.heads;
  if (blocks > 0x7fffffffLL) return -1;
  kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, kBytes, stream>>>(a, groups, bias_vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch mma_attend_kernel over `groups` regions (B x regions), rows of
// head_cols(a.d), 64 or 128 query rows a block (`attend_rows`); returns 0,
// -1 (d > 64 or shared memory) or a cudaError_t.
int launch_mma_attend(const AttnArgs& a, int groups, cudaStream_t stream) {
  int err = 0;
  const int rows = attend_rows(a.Nq, groups, a.heads, a.d, &err);
  if (err) return err;
  if (a.d <= 32)
    return rows == 128 ? launch_mma_attend_rows<32, 8>(a, groups, stream)
                       : launch_mma_attend_rows<32, 4>(a, groups, stream);
  return rows == 128 ? launch_mma_attend_rows<64, 8>(a, groups, stream)
                     : launch_mma_attend_rows<64, 4>(a, groups, stream);
}

}  // namespace
}  // namespace grlir
