// Window half of GRL's mixed attention for windows of more than 512 tokens
// (GRL-base at window 32: N = 1024).
//
// Replaces the Pallas kernel `_window_block_kernel`, q-tiled large-window
// branch (grlir/ops/pallas/block_attn.py:311-323, q_tile :366-370, entry
// `fused_window_half`).  Same math as window_half.cu: project q, k, v of
// each head from the NHWC x (the cyclic window shift applied while
// reading), unit-norm q (times the logit scale) and k, cosine attention
// with the continuous position bias, which the TPU keeps in bf16 whatever
// x's type, and the shift-band mask; the head's output channels are written
// NHWC in rolled coordinates.  Softmax as the TPU's (:286-301): e = exp(s -
// max) in fp32, rounded to x's type for the product with v, which is then
// scaled by 1/sum (deferred normalisation).
//
// What bounds it on an H100: a (window, head) needs N * 3d values of q, k
// and v (1024 x 90 x 4 B = 369 KB in fp32), more than one block's 227 KB of
// shared memory, and its N x N logits (4 MB) far more.  The TPU walks q in
// row tiles against k and v resident in VMEM.  Here a projection kernel
// writes q, k and v once to a workspace (it stays in the 50 MB L2 at
// GRL-base's 256^2 tile), and an attention kernel streams k, v and the bias
// through shared memory for tiles of query rows, in one pass.  The work is
// 2 N^2 d multiply-adds a window and head for the attention and 3 N C d for
// the projection; the bias (3 x 2 MB in bf16) is the one large operand,
// shared by every window.
//
// bf16 (the served route, `grlir_window_half_large_mma`): B4's tensor-core
// pipeline (stripe_attn_mma.cuh, mma_attend.cuh) with B3's rounding:
// mma.sync m16n8k16 with bf16 operands and fp32 sums; the projection folds
// the logit scale into q after the unit norm and before the bf16 rounding,
// as the TPU does (:272, :280), into workspace rows padded to 32 or 64
// (zeros past d, so that d = 30 keeps 16-byte copies); the attention rounds
// exp(s - max) and scales the product by 1/sum, 64 or 128 query rows a
// block with the window the grid's fastest index, so each bias tile comes
// from HBM about once and from L2 for the other B x 64 windows.
//
// fp32 (`grlir_window_half_large`): the TPU kernel then computes in fp32,
// and TF32 products would not hold it, so the route stays on CUDA cores
// (large_attn.cuh): fp32 FMAs, one block per (window, head, 32 rows).
#include "mma_attend.cuh"

namespace grlir {
namespace {

// Attention operands of a (window, head) in the workspace [window][head]
// [q|k|v][N][ld]; y NHWC at the windows' tokens, rolled coordinates.
AttnArgs window_args(const void* ws, size_t elem, int ld, const void* bias, const int* bands,
                     void* y, int H, int W, int d, int heads, int wh, int ww) {
  const long long part = (long long)wh * ww * ld;
  AttnArgs a{};
  a.q = ws;
  a.k = static_cast<const char*>(ws) + elem * part;
  a.v = static_cast<const char*>(ws) + 2 * elem * part;
  a.q_stride = a.k_stride = a.v_stride = 3 * part;
  a.Nq = a.Nk = wh * ww;
  a.d = d;
  a.heads = heads;
  a.regions = (H / wh) * (W / ww);
  a.scale = nullptr;  // folded into q
  a.bias = bias;
  a.band_q = a.band_k = bands;
  a.out = y;
  a.H = H;
  a.W = W;
  a.rh = wh;
  a.rw = ww;
  return a;
}

int window_half_large_fp32(const void* x, const void* w, const float* bqkv, const float* scale,
                           const void* bias, const int* bands, void* ws, void* y, int B, int H,
                           int W, int C, int Cw, int heads, int wh, int ww, int shift,
                           cudaStream_t stream) {
  const int d = Cw / heads;
  if (d > kMaxD) return -1;
  const Regions reg{H, W, wh, ww, shift, shift};
  // q (unit-normed, times the scale), k (unit-normed), v
  int err = launch_project<float>(x, w, bqkv, scale, ws, reg, B, C, Cw, heads, 0, 3, 0b011, stream);
  if (err) return err;
  const AttnArgs a = window_args(ws, sizeof(float), d, bias, bands, y, H, W, d, heads, wh, ww);
  return launch_attend<float, __nv_bfloat16, true>(a, B * a.regions, stream);
}

int window_half_large_mma(const void* x, const void* wt, const float* bp, const float* scale,
                          const void* bias, const int* bands, void* ws, void* y, int B, int H,
                          int W, int C, int Cw, int heads, int wh, int ww, int shift, int Cp,
                          cudaStream_t stream) {
  const int d = Cw / heads;
  if (d > kMaxD) return -1;
  const Regions reg{H, W, wh, ww, shift, shift};
  // q (unit-normed, times the scale), k (unit-normed), v, in rows of 32 or 64
  int err =
      launch_mma_project(x, wt, bp, scale, nullptr, ws, reg, B, C, Cp, heads, d, 3, 0b011, stream);
  if (err) return err;
  const AttnArgs a =
      window_args(ws, sizeof(bf16), head_cols(d), bias, bands, y, H, W, d, heads, wh, ww);
  return launch_mma_attend(a, B * a.regions, stream);
}

}  // namespace
}  // namespace grlir

// fp32.  x (B, H, W, C) unrolled; w (C, 3Cw); bqkv (3Cw,); scale (heads,)
// exp(min(logit_scale, log 100)); all fp32; bias (heads, N, N) bf16; bands
// (windows, N) int32 or null; ws: B * windows * heads * 3 * N * d floats;
// y (B, H, W, Cw).  Returns 0 on success, -1 when the geometry is beyond
// the kernels (d > 64 or shared memory), or the cudaError_t of a failed
// launch.
extern "C" int grlir_window_half_large(const void* x, const void* w, const float* bqkv,
                                       const float* scale, const void* bias, const int* bands,
                                       void* ws, void* y, int B, int H, int W, int C, int Cw,
                                       int heads, int wh, int ww, int shift, void* stream) {
  return grlir::window_half_large_fp32(x, w, bqkv, scale, bias, bands, ws, y, B, H, W, C, Cw,
                                       heads, wh, ww, shift, static_cast<cudaStream_t>(stream));
}

// bf16 on tensor cores.  x, bias and y as for the fp32 entry in bf16; wt
// (3Cw, Cp) bf16: w transposed, rows Cp apart (C rounded up to 16; values
// past C are not read); bp (3Cw,) fp32; scale as for the fp32 entry; ws:
// B * windows * heads * 3 * N * DP bf16 (DP = 32 for d <= 32, else 64).
extern "C" int grlir_window_half_large_mma(const void* x, const void* wt, const float* bp,
                                           const float* scale, const void* bias,
                                           const int* bands, void* ws, void* y, int B, int H,
                                           int W, int C, int Cw, int heads, int wh, int ww,
                                           int shift, int Cp, void* stream) {
  return grlir::window_half_large_mma(x, wt, bp, scale, bias, bands, ws, y, B, H, W, C, Cw,
                                      heads, wh, ww, shift, Cp,
                                      static_cast<cudaStream_t>(stream));
}
