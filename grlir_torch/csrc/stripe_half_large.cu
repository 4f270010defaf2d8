// Anchored-stripe half of GRL's mixed attention for stripes whose biases
// exceed the resident budget (GRL-base at stripes 64x64 or 64x128 and anchor
// down-factor 2: N1 = 4096 or 8192 tokens, N2 = N1 / 4 anchors).
//
// Replaces the Pallas kernels `_stripe_a2w_large_kernel` and
// `_stripe_w2a_large_kernel` (grlir/ops/pallas/block_attn.py:1037-1171,
// driven by `_stripe_half_large_call` :1174-1283), two C entries a step:
//   a2w: x1 = softmax_N1(norm(a) . norm(k)^T * s1 + bias_a2w + mask) v
//   w2a: y  = softmax_N2(norm(q) . norm(a)^T * s2 + bias_w2a + mask) x1
// with the TPU kernels' numerics: biases in x's type, the logit scale
// applied after the product, the softmax's probabilities rounded to x's
// type (the TPU normalises them first; the bf16 route scales the product by
// 1/sum after it, stripe_attn_mma.cuh), and x1 written in x's type between
// the two steps.  x is read NHWC with the cyclic stripe shift applied while
// reading; the anchor arrives rolled; y is written NHWC in rolled
// coordinates.  Horizontal and vertical stripes are the same code.
//
// Each step projects once per stripe into a workspace that stays in L2 and
// unit-norms the anchors once, then one attention kernel streams the keys
// and the bias in one pass (an online softmax).  The work is 4 N1 N2 d
// multiply-adds a stripe and head.
//
// bf16 (the served route, `*_mma` entries): the products run on tensor
// cores, mma.sync m16n8k16 with bf16 operands and fp32 sums, exactly the
// TPU's matmul numerics (stripe_attn_mma.cuh, mma_attend.cuh).  At d = 32
// the products are short, so the per-logit fp32 work (scale, bias, mask,
// max, exp, sum) weighs as much as the mma issue rate; the bias is the one
// large operand.  It is shared by every stripe, and the attention grid runs
// the B x stripes readers of one (head, row tile) bias tile next to each
// other, so it comes from HBM about once a step and from L2 for the others:
// 25.2 MB a step at GRL-base x4 SR 256^2 (3 x 1024 x 4096 bf16 each way)
// and 100.7 MB at its 2 x 256^2 denoising tile, against 16 readers each.  Workspace rows
// are zero-padded to 32 (64 for d > 32) so that every attention load is a
// 16-byte cp.async: the projection and the anchors write rows of that
// width, and the w2a step pads x1.
//
// fp32 (`grlir_stripe_*_large`): the TPU kernel then computes in fp32, and
// TF32 products would not hold it, so the route stays on CUDA cores
// (large_attn.cuh): fp32 FMAs, one block per (stripe, head, 32 rows).
#include "mma_attend.cuh"

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

// The a2w attention's operands: q the unit anchors, k and v parts 0 and 1
// of ws_kv, rows of `ld` elements; out x1 [stripe][head][N2][d].
AttnArgs a2w_args(const void* ws_an, const void* ws_kv, size_t elem, int ld, const float* s1,
                  const void* bias, const int* bands, const int* bands_a, void* x1,
                  const StripeGeom& G) {
  const int N1 = G.N1(), N2 = G.N2();
  AttnArgs a{};
  a.q = ws_an;
  a.q_stride = (long long)N2 * ld;
  a.k = ws_kv;
  a.v = static_cast<const char*>(ws_kv) + elem * N1 * ld;
  a.k_stride = a.v_stride = 2LL * N1 * ld;
  a.Nq = N2;
  a.Nk = N1;
  a.d = G.d();
  a.heads = G.heads;
  a.regions = G.stripes();
  a.scale = s1;
  a.bias = bias;
  a.band_q = bands ? bands_a : nullptr;
  a.band_k = bands;
  a.out = x1;
  return a;
}

// The w2a attention's operands: q from ws_q, k the unit anchors, v x1,
// rows of `ld` elements; out y NHWC at the stripes' tokens.
AttnArgs w2a_args(const void* ws_q, const void* ws_an, const void* x1, int ld, const float* s2,
                  const void* bias, const int* bands, const int* bands_a, void* y,
                  const StripeGeom& G) {
  AttnArgs a{};
  a.q = ws_q;
  a.q_stride = (long long)G.N1() * ld;
  a.k = ws_an;
  a.v = x1;
  a.k_stride = a.v_stride = (long long)G.N2() * ld;
  a.Nq = G.N1();
  a.Nk = G.N2();
  a.d = G.d();
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
  return a;
}

int anchor_units(const void* anchor, void* ws_an, int ld, bool bf16_in, const StripeGeom& G,
                 cudaStream_t stream) {
  const int Ha = G.H / G.df, Wa = G.W / G.df, ah = G.sh / G.df, aw = G.sw / G.df;
  if (bf16_in)
    return launch_anchor_units<__nv_bfloat16>(anchor, ws_an, G.B, Ha, Wa, G.Cs, G.heads, ah, aw,
                                              ld, stream);
  return launch_anchor_units<float>(anchor, ws_an, G.B, Ha, Wa, G.Cs, G.heads, ah, aw, ld,
                                    stream);
}

int a2w_fp32(const void* x, const void* anchor, const void* w, const float* bqkv,
             const float* s1, const void* bias, const int* bands, const int* bands_a,
             void* ws_an, void* ws_kv, void* x1, const StripeGeom& G, cudaStream_t stream) {
  const int d = G.d();
  if (d > kMaxD) return -1;
  int err = anchor_units(anchor, ws_an, d, false, G, stream);
  if (err) return err;
  // k (unit-normed) and v of every stripe: parts 1 and 2 of the projection
  err = launch_project<float>(x, w, bqkv, nullptr, ws_kv, G.regions(), G.B, G.C, G.Cs, G.heads,
                              1, 2, 0b01, stream);
  if (err) return err;
  const AttnArgs a =
      a2w_args(ws_an, ws_kv, sizeof(float), d, s1, bias, bands, bands_a, x1, G);
  return launch_attend<float, float, false>(a, G.B * a.regions, stream);
}

int w2a_fp32(const void* x, const void* anchor, const void* x1, const void* w,
             const float* bqkv, const float* s2, const void* bias, const int* bands,
             const int* bands_a, void* ws_an, void* ws_q, void* y, const StripeGeom& G,
             cudaStream_t stream) {
  const int d = G.d();
  if (d > kMaxD) return -1;
  int err = anchor_units(anchor, ws_an, d, false, G, stream);
  if (err) return err;
  // q (unit-normed) of every stripe: part 0 of the projection
  err = launch_project<float>(x, w, bqkv, nullptr, ws_q, G.regions(), G.B, G.C, G.Cs, G.heads,
                              0, 1, 0b1, stream);
  if (err) return err;
  const AttnArgs a = w2a_args(ws_q, ws_an, x1, d, s2, bias, bands, bands_a, y, G);
  return launch_attend<float, float, false>(a, G.B * a.regions, stream);
}

int a2w_mma(const void* x, const void* anchor, const void* wt, const float* bp,
            const float* s1, const void* bias, const int* bands, const int* bands_a,
            void* ws_an, void* ws_kv, void* x1, int Cp, const StripeGeom& G,
            cudaStream_t stream) {
  if (G.d() > kMaxD) return -1;
  const int dp = head_cols(G.d());
  int err = anchor_units(anchor, ws_an, dp, true, G, stream);
  if (err) return err;
  // k (unit-normed) and v of every stripe: wt holds the k and v parts
  err = launch_mma_project(x, wt, bp, nullptr, nullptr, ws_kv, G.regions(), G.B, G.C, Cp,
                           G.heads, G.d(), 2, 0b01, stream);
  if (err) return err;
  const AttnArgs a =
      a2w_args(ws_an, ws_kv, sizeof(bf16), dp, s1, bias, bands, bands_a, x1, G);
  return launch_mma_attend(a, G.B * a.regions, stream);
}

int w2a_mma(const void* x, const void* anchor, const void* x1, const void* wt,
            const float* bp, const float* s2, const void* bias, const int* bands,
            const int* bands_a, void* ws_an, void* ws_q, void* ws_x1, void* y, int Cp,
            const StripeGeom& G, cudaStream_t stream) {
  const int d = G.d();
  if (d > kMaxD) return -1;
  const int dp = head_cols(d);
  int err = anchor_units(anchor, ws_an, dp, true, G, stream);
  if (err) return err;
  // q (unit-normed) of every stripe: wt holds the q part
  err = launch_mma_project(x, wt, bp, nullptr, nullptr, ws_q, G.regions(), G.B, G.C, Cp,
                           G.heads, d, 1, 0b1, stream);
  if (err) return err;
  err = launch_pad_rows(x1, ws_x1, (long long)G.B * G.stripes() * G.heads * G.N2(), d, stream);
  if (err) return err;
  const AttnArgs a = w2a_args(ws_q, ws_an, ws_x1, dp, s2, bias, bands, bands_a, y, G);
  return launch_mma_attend(a, G.B * a.regions, stream);
}

}  // namespace
}  // namespace grlir

// a2w step, fp32.  x (B, H, W, C) unrolled; anchor (B, H/df, W/df, Cs)
// rolled; w (C, 3Cs); bqkv (3Cs,); s1 (heads,) scale; bias (heads, N2, N1);
// all fp32; bands (stripes, N1) and bands_a (stripes, N2) int32, or both
// null; ws_an: B * stripes * heads * N2 * d and ws_kv: B * stripes * heads *
// 2 * N1 * d floats; x1 (B, stripes, heads, N2, d) out.  Returns 0, -1
// (d > 64 or shared memory) or a cudaError_t.
extern "C" int grlir_stripe_a2w_large(const void* x, const void* anchor, const void* w,
                                      const float* bqkv, const float* s1, const void* bias,
                                      const int* bands, const int* bands_a, void* ws_an,
                                      void* ws_kv, void* x1, int B, int H, int W, int C, int Cs,
                                      int heads, int sh, int sw, int df, int shift_h,
                                      int shift_w, void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  return grlir::a2w_fp32(x, anchor, w, bqkv, s1, bias, bands, bands_a, ws_an, ws_kv, x1, G,
                         static_cast<cudaStream_t>(stream));
}

// w2a step, fp32.  x1 from the a2w step; bias (heads, N1, N2); ws_q:
// B * stripes * heads * N1 * d floats; y (B, H, W, Cs) out, rolled
// coordinates; the rest as for the a2w step.
extern "C" int grlir_stripe_w2a_large(const void* x, const void* anchor, const void* x1,
                                      const void* w, const float* bqkv, const float* s2,
                                      const void* bias, const int* bands, const int* bands_a,
                                      void* ws_an, void* ws_q, void* y, int B, int H, int W,
                                      int C, int Cs, int heads, int sh, int sw, int df,
                                      int shift_h, int shift_w, void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  return grlir::w2a_fp32(x, anchor, x1, w, bqkv, s2, bias, bands, bands_a, ws_an, ws_q, y, G,
                         static_cast<cudaStream_t>(stream));
}

// a2w step, bf16 on tensor cores.  x, anchor, bias and x1 as for the fp32
// entry in bf16; wt (2Cs, Cp) bf16: the k and v columns of w, transposed,
// rows Cp apart (C rounded up to 16; values past C are not read); bp (2Cs,)
// fp32: the k and v values of bqkv; s1 fp32; ws_an: B * stripes * heads *
// N2 * DP and ws_kv: B * stripes * heads * 2 * N1 * DP bf16 (DP = 32 for
// d <= 32, else 64).
extern "C" int grlir_stripe_a2w_large_mma(const void* x, const void* anchor, const void* wt,
                                          const float* bp, const float* s1, const void* bias,
                                          const int* bands, const int* bands_a, void* ws_an,
                                          void* ws_kv, void* x1, int B, int H, int W, int C,
                                          int Cs, int heads, int sh, int sw, int df,
                                          int shift_h, int shift_w, int Cp, void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  return grlir::a2w_mma(x, anchor, wt, bp, s1, bias, bands, bands_a, ws_an, ws_kv, x1, Cp, G,
                        static_cast<cudaStream_t>(stream));
}

// w2a step, bf16 on tensor cores.  wt (Cs, Cp) and bp (Cs,): the q
// columns, laid out as for the a2w entry; ws_q: B * stripes * heads * N1 *
// DP and ws_x1: B * stripes * heads * N2 * DP bf16 (DP as for the a2w
// entry); the rest as for the fp32 w2a entry in bf16.
extern "C" int grlir_stripe_w2a_large_mma(const void* x, const void* anchor, const void* x1,
                                          const void* wt, const float* bp, const float* s2,
                                          const void* bias, const int* bands, const int* bands_a,
                                          void* ws_an, void* ws_q, void* ws_x1, void* y, int B,
                                          int H, int W, int C, int Cs, int heads, int sh, int sw,
                                          int df, int shift_h, int shift_w, int Cp,
                                          void* stream) {
  const grlir::StripeGeom G{B, H, W, C, Cs, heads, sh, sw, df, shift_h, shift_w};
  return grlir::w2a_mma(x, anchor, x1, wt, bp, s2, bias, bands, bands_a, ws_an, ws_q, ws_x1, y,
                        Cp, G, static_cast<cudaStream_t>(stream));
}

// The query rows a block of mma_attend_kernel takes (64 or 128, into
// *rows) for Nq query rows of `groups` regions (B x regions) and `heads`
// heads of dim d: the rule every launch of B3's, B4's and B5's tensor-core
// routes applies, for their launch counters.  Returns 0, -1 (d > 64 or
// shared memory) or a cudaError_t.
extern "C" int grlir_mma_attend_rows(long long Nq, long long groups, int heads, int d,
                                     int* rows) {
  int err = 0;
  *rows = grlir::attend_rows(Nq, groups, heads, d, &err);
  return err;
}
