// Anchored-stripe half of GRL's mixed attention for stripes whose biases
// exceed the resident budget (GRL-base at stripes 64x64 or 64x128 and anchor
// down-factor 2: N1 = 4096 or 8192 tokens, N2 = N1 / 4 anchors).
//
// Replaces the Pallas kernels `_stripe_a2w_large_kernel` and
// `_stripe_w2a_large_kernel` (grlir/ops/pallas/block_attn.py:1037-1171,
// driven by `_stripe_half_large_call` :1174-1283), one C entry each:
//   a2w: x1 = softmax_N1(norm(a) . norm(k)^T * s1 + bias_a2w + mask) v
//   w2a: y  = softmax_N2(norm(q) . norm(a)^T * s2 + bias_w2a + mask) x1
// with the TPU kernels' numerics: biases in x's type, the logit scale
// applied after the product, the softmax normalised before its
// probabilities are rounded to x's type, and x1 written in x's type
// between the two steps.  x is read NHWC with the cyclic stripe shift
// applied while reading; the anchor arrives rolled; y is written NHWC in
// rolled coordinates.  Horizontal and vertical stripes are the same code.
//
// What bounds it on an H100: one a2w logit row is N1 fp32 values (16-32
// KB) and k, v of a stripe N1 x 2d, so no row and no stripe's k/v fits a
// block next to its neighbours.  As on the TPU, k and v (a2w) and q (w2a)
// are projected once per stripe, here by a projection kernel into a
// workspace that stays in L2 (2 x N1 x d x 2 B = 0.5-1 MB a stripe and head
// in bf16), and the anchors are unit-normed once.  The attention kernel
// then runs one block per (stripe, head, 32 rows) — the TPU grid's split of
// N2 (a2w) and N1 (w2a) — and streams keys and values through shared
// memory twice: max and sum first, then normalised probabilities times v
// (large_attn.cuh).  At GRL-base's dn tile (8 stripes x 3 heads) that is
// 1536 a2w and 6144 w2a blocks.  The work is 4 N1 N2 d FMAs a stripe and
// head (plus a third again for the second logit pass), on CUDA cores in
// fp32 on operands rounded to x's type: FMA throughput bounds it, not HBM (the
// biases, N1 N2 values a head and direction, are read once per block row
// from L2).  Tensor cores (mma/wgmma) are later work.
#include "large_attn.cuh"

namespace grlir {
namespace {

struct StripeGeom {
  int B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w;
  int d() const { return Cs / heads; }
  int N1() const { return sh * sw; }
  int N2() const { return (sh / df) * (sw / df); }
  int stripes() const { return (H / sh) * (W / sw); }
  Regions regions() const { return Regions{H, W, sh, sw, shift_h, shift_w}; }
};

template <typename T>
int launch_a2w(const void* x, const void* anchor, const void* w, const float* bqkv,
               const float* s1, const void* bias, const int* bands, const int* bands_a,
               void* ws_an, void* ws_kv, void* x1, const StripeGeom& G, cudaStream_t stream) {
  const int d = G.d(), N1 = G.N1(), N2 = G.N2();
  if (d > kDP) return -1;
  int err = launch_anchor_units<T>(anchor, ws_an, G.B, G.H / G.df, G.W / G.df, G.Cs, G.heads,
                                   G.sh / G.df, G.sw / G.df, stream);
  if (err) return err;
  // k (unit-normed) and v of every stripe: parts 1 and 2 of the projection
  err = launch_project<T>(x, w, bqkv, nullptr, ws_kv, G.regions(), G.B, G.C, G.Cs, G.heads, 1,
                          2, 0b01, stream);
  if (err) return err;
  AttnArgs a{};
  a.q = ws_an;
  a.q_stride = (long long)N2 * d;
  a.k = ws_kv;
  a.v = static_cast<const T*>(ws_kv) + (long long)N1 * d;
  a.k_stride = a.v_stride = 2LL * N1 * d;
  a.Nq = N2;
  a.Nk = N1;
  a.d = d;
  a.heads = G.heads;
  a.regions = G.stripes();
  a.scale = s1;
  a.bias = bias;
  a.band_q = bands ? bands_a : nullptr;
  a.band_k = bands;
  a.out = x1;  // [stripe][head][N2][d]
  return launch_attend<T, T, false>(a, G.B * a.regions, stream);
}

template <typename T>
int launch_w2a(const void* x, const void* anchor, const void* x1, const void* w,
               const float* bqkv, const float* s2, const void* bias, const int* bands,
               const int* bands_a, void* ws_an, void* ws_q, void* y, const StripeGeom& G,
               cudaStream_t stream) {
  const int d = G.d(), N1 = G.N1(), N2 = G.N2();
  if (d > kDP) return -1;
  int err = launch_anchor_units<T>(anchor, ws_an, G.B, G.H / G.df, G.W / G.df, G.Cs, G.heads,
                                   G.sh / G.df, G.sw / G.df, stream);
  if (err) return err;
  // q (unit-normed) of every stripe: part 0 of the projection
  err = launch_project<T>(x, w, bqkv, nullptr, ws_q, G.regions(), G.B, G.C, G.Cs, G.heads, 0, 1,
                          0b1, stream);
  if (err) return err;
  AttnArgs a{};
  a.q = ws_q;
  a.q_stride = (long long)N1 * d;
  a.k = ws_an;
  a.v = x1;
  a.k_stride = a.v_stride = (long long)N2 * d;
  a.Nq = N1;
  a.Nk = N2;
  a.d = d;
  a.heads = G.heads;
  a.regions = G.stripes();
  a.scale = s2;
  a.bias = bias;
  a.band_q = bands;
  a.band_k = bands ? bands_a : nullptr;
  a.out = y;
  a.H = G.H;
  a.W = G.W;
  a.rh = G.sh;
  a.rw = G.sw;
  return launch_attend<T, T, false>(a, G.B * a.regions, stream);
}

}  // namespace
}  // namespace grlir

// a2w step.  x (B, H, W, C) unrolled; anchor (B, H/df, W/df, Cs) rolled, in
// x's type; w (C, 3Cs); bqkv (3Cs,) fp32; s1 (heads,) fp32 scale; bias
// (heads, N2, N1) in x's type; bands (stripes, N1) and bands_a (stripes, N2)
// int32, or both null; ws_an: B * stripes * heads * N2 * d and ws_kv:
// B * stripes * heads * 2 * N1 * d elements of x's type; x1 (B, stripes,
// heads, N2, d) out.  Returns 0, -1 (d > 32 or shared memory) or a
// cudaError_t.
extern "C" int grlir_stripe_a2w_large(const void* x, const void* anchor, const void* w,
                                      const float* bqkv, const float* s1, const void* bias,
                                      const int* bands, const int* bands_a, void* ws_an,
                                      void* ws_kv, void* x1, int B, int H, int W, int C, int Cs,
                                      int heads, int sh, int sw, int df, int shift_h,
                                      int shift_w, int is_bf16, void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_a2w<__nv_bfloat16>(x, anchor, w, bqkv, s1, bias, bands, bands_a, ws_an,
                                            ws_kv, x1, G, s);
  return grlir::launch_a2w<float>(x, anchor, w, bqkv, s1, bias, bands, bands_a, ws_an, ws_kv, x1,
                                  G, s);
}

// w2a step.  x1 from the a2w step; bias (heads, N1, N2) in x's type; ws_q:
// B * stripes * heads * N1 * d elements; y (B, H, W, Cs) out, rolled
// coordinates; the rest as for the a2w step.
extern "C" int grlir_stripe_w2a_large(const void* x, const void* anchor, const void* x1,
                                      const void* w, const float* bqkv, const float* s2,
                                      const void* bias, const int* bands, const int* bands_a,
                                      void* ws_an, void* ws_q, void* y, int B, int H, int W,
                                      int C, int Cs, int heads, int sh, int sw, int df,
                                      int shift_h, int shift_w, int is_bf16, void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grlir::launch_w2a<__nv_bfloat16>(x, anchor, x1, w, bqkv, s2, bias, bands, bands_a,
                                            ws_an, ws_q, y, G, s);
  return grlir::launch_w2a<float>(x, anchor, x1, w, bqkv, s2, bias, bands, bands_a, ws_an, ws_q,
                                  y, G, s);
}
