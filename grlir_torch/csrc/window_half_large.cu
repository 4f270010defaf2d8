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
// NHWC in rolled coordinates.
//
// What bounds it on an H100: a (window, head) needs N * 3d values of q, k
// and v (1024 x 90 x 4 B = 369 KB in fp32), more than one block's 227 KB of
// shared memory, and its N x N logits (4 MB) far more.  The TPU walks q in
// row tiles against k and v resident in VMEM.  Here a projection kernel
// writes q, k and v once to a workspace (2 x 3 x N x d bytes a window and
// head in bf16; it stays in the 50 MB L2 at GRL-base's 256^2 tile), and the
// attention kernel runs one block per 32 query rows, streaming k and v
// through shared memory (large_attn.cuh).  The FLOPs (2 N^2 d a head for
// the attention, 3 N C d for the projection) run on CUDA cores in fp32 on
// operands rounded to x's type, so FMA throughput bounds it, not HBM: at 256^2
// the kernel reads x once and the bias once per block from L2.  Tensor
// cores (mma/wgmma) are later work.
#include "large_attn.cuh"

namespace grlir {
namespace {

template <typename T>
int launch_window_half_large(const void* x, const void* w, const float* bqkv,
                             const float* scale, const void* bias, const int* bands, void* ws,
                             void* y, int B, int H, int W, int C, int Cw, int heads, int wh,
                             int ww, int shift, cudaStream_t stream) {
  const int d = Cw / heads, N = wh * ww;
  if (d > kDP) return -1;
  const Regions reg{H, W, wh, ww, shift, shift};
  // q (unit-normed, times the scale), k (unit-normed), v
  int err = launch_project<T>(x, w, bqkv, scale, ws, reg, B, C, Cw, heads, 0, 3, 0b011, stream);
  if (err) return err;
  AttnArgs a{};
  const long long part = (long long)N * d;
  a.q = ws;
  a.k = static_cast<const T*>(ws) + part;
  a.v = static_cast<const T*>(ws) + 2 * part;
  a.q_stride = a.k_stride = a.v_stride = 3 * part;
  a.Nq = a.Nk = N;
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
  return launch_attend<T, __nv_bfloat16, true>(a, B * a.regions, stream);
}

}  // namespace
}  // namespace grlir

// x (B, H, W, C) unrolled; w (C, 3Cw); bqkv (3Cw,) fp32; scale (heads,)
// fp32 exp(min(logit_scale, log 100)); bias (heads, N, N) bf16; bands
// (windows, N) int32 or null; ws: workspace of B * windows * heads * 3 * N * d
// elements of x's type; y (B, H, W, Cw).  Returns 0 on success, -1 when the
// geometry is beyond the kernels (d > 32 or shared memory), or the
// cudaError_t of a failed launch.
extern "C" int grlir_window_half_large(const void* x, const void* w, const float* bqkv,
                                       const float* scale, const void* bias, const int* bands,
                                       void* ws, void* y, int B, int H, int W, int C, int Cw,
                                       int heads, int wh, int ww, int shift, int is_bf16,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_window_half_large<__nv_bfloat16>(x, w, bqkv, scale, bias, bands, ws, y,
                                                          B, H, W, C, Cw, heads, wh, ww, shift,
                                                          s);
  return grlir::launch_window_half_large<float>(x, w, bqkv, scale, bias, bands, ws, y, B, H, W,
                                                C, Cw, heads, wh, ww, shift, s);
}
