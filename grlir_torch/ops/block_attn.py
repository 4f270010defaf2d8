"""Whole block-half attention: NHWC x in, NHWC attention output out.

Torch counterparts of `fused_window_half` and `fused_stripe_half`
(grlir/ops/pallas/block_attn.py).  Each half routes a geometry as the TPU
does (`window_route`, `stripe_route`) to one of four kernels, each
hand-written in CUDA with a plain PyTorch version beside it:

  window, N <= 512 (B1)       csrc/window_half.cu        window_half_ref
  window, N > 512 (B3)        csrc/window_half_large.cu  window_half_large_ref
  stripe, resident bias (B2)  csrc/stripe_half.cu        stripe_half_ref
  stripe, streamed bias (B4)  csrc/stripe_half_large.cu  stripe_a2w_large_ref,
                                                         stripe_w2a_large_ref

All four take one of two routes by x's type, chosen before any launch:
bf16 on tensor cores (csrc/stripe_attn_mma.cuh; B1 one fused kernel), fp32
on CUDA cores; each wrapper counts its launches by route in
`route_launches`.

Dispatch (`kernels=True`, the default): a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version.  `kernels=False` runs the plain
version on any device.  A geometry that no TPU kernel takes raises
NotImplementedError either way: the model routes such a half to its plain
cosine attention (`grlir_torch.models.blocks`) before it gets here, and
counts it in `unrouted_halves`.  The kernels take head dims up to `MAX_D`
(their rows are padded to 32 or 64 columns; B1's and B2's fp32 routes up to
where a block's shared memory ends); a CUDA tensor with a wider head
raises.  Under grad the kernels run forward and their backward is autograd
of the plain version on the same inputs (`_PlainGrad`), as the JAX
package's custom VJPs recompute their XLA twins
(grlir/ops/pallas/block_attn.py:553-586).

Every version pins the numerics of its TPU kernel: q, k and anchors are
unit-normed as t * rsqrt(max(sum t^2, 1e-24)); the logit scale is
exp(min(s, log 100)); the shift mask adds -100 where band ids differ; every
product's operands are rounded to the input type (bf16 when x is bf16) and
summed in fp32; softmax is fp32.  B1, B2 and B3 fold the scale into q (k for
a2w) before the product and apply the 1/sum after the product with v; B3
rounds its bias to bf16.  B4 scales the logits after the product, keeps its
biases in x's type, normalises the softmax before rounding it, and writes
x1 in x's type between its two steps.  Outputs are in rolled coordinates:
the caller un-rolls them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from grlir_torch.ops import cuda_build
from grlir_torch.ops.layout import window_partition, window_reverse
from grlir_torch.utils.profiling import kernel_work, tensor_bytes

Size2 = Tuple[int, int]

# The TPU kernels' own admission rules, restated (block_attn.py:68-151),
# with the same names so that a test can monkeypatch them.  Each geometry
# has one route, and the routes round differently: small windows (B1) and
# resident-bias stripes (B2) keep fp32 biases; large windows (B3) store the
# bias in bf16 and stripes beyond the resident budget (B4) stream it in x's
# type.
_BIAS_VMEM_BUDGET = 4 * 1024 * 1024
_LARGE_N = 512
_LARGE_BIAS_BUDGET = 8 * 1024 * 1024
_STRIPE_ATTN_BUDGET = 4 * 1024 * 1024


def _auto_pack_w(W: int, window: Size2) -> int:
    wh, ww = window
    pack_w = max(1, min(W // ww, -(-128 // (wh * ww)) * 2))
    while (W // ww) % pack_w:
        pack_w -= 1
    return pack_w


def window_route(x_size: Size2, window: Size2, num_heads: int) -> Optional[str]:
    """"small" (B1), "large" (B3) or None: the TPU's route for a window."""
    H, W = x_size
    wh, ww = window
    if H % wh or W % ww:
        return None
    N = wh * ww
    if N > _LARGE_N:
        fits = num_heads * N * N * 2 <= _LARGE_BIAS_BUDGET
        return "large" if fits else None
    PN = _auto_pack_w(W, window) * N
    return "small" if num_heads * PN * PN * 4 <= _BIAS_VMEM_BUDGET else None


def _stripe_resident_supported(stripe: Size2, df: int, num_heads: int) -> bool:
    sh, sw = stripe
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    return 2 * num_heads * N2 * N1 * 4 <= _BIAS_VMEM_BUDGET


def _stripe_large_tiles(stripe: Size2, df: int, num_heads: int):
    """(n2_tile, n1_tile) of the TPU's streamed-bias path, or None.  The
    port's kernels tile on their own; only the admission matters here."""
    sh, sw = stripe
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    n2t = min(N2, max(8, _STRIPE_ATTN_BUDGET // (4 * num_heads * N1)
                      // 8 * 8))
    while n2t >= 8 and N2 % n2t:
        n2t -= 8
    if n2t < 8 or num_heads * n2t * N1 * 4 > _STRIPE_ATTN_BUDGET:
        return None
    rows = max(1, _STRIPE_ATTN_BUDGET // (4 * num_heads * N2) // sw)
    n1t = min(N1, rows * sw)
    while n1t >= sw and (N1 % n1t or not (n1t % 128 == 0 or n1t == N1)):
        n1t -= sw
    if n1t < sw or num_heads * N2 * n1t * 4 > _STRIPE_ATTN_BUDGET:
        return None
    return n2t, n1t


def stripe_route(x_size: Size2, stripe: Size2, df: int,
                 num_heads: int) -> Optional[str]:
    """"resident" (B2), "large" (B4) or None: the TPU's route for a
    stripe."""
    H, W = x_size
    sh, sw = stripe
    if H % sh or W % sw or sh % df or sw % df:
        return None
    if _stripe_resident_supported(stripe, df, num_heads):
        return "resident"
    return "large" if _stripe_large_tiles(stripe, df, num_heads) else None


def _scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """(h,) fp32 exp(min(logit_scale, log 100))."""
    s = torch.clamp(logit_scale.float(), max=math.log(100.0))
    return torch.exp(s).reshape(-1)


def _unit(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t * rsqrt(max(sum t^2, 1e-24)) over `dim`: the kernels' unit norm."""
    return t * torch.rsqrt(torch.clamp((t * t).sum(dim, keepdim=True),
                                       min=1e-24))


def _band_mask(bq: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    """(nW, Nq) x (nW, Nk) band ids -> (nW, 1, Nq, Nk) additive {0, -100}."""
    diff = bq[:, :, None] != bk[:, None, :]
    return torch.where(diff, -100.0, 0.0)[:, None].to(torch.float32)


def _softmax_times(logits: torch.Tensor, v: torch.Tensor, mm: torch.dtype):
    """fp32 softmax over the last axis times v, with exp rounded to mm and
    the 1/sum applied after the product (the kernels' deferred
    normalisation)."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rs = 1.0 / e.sum(-1, keepdim=True)
    return (e.to(mm).float() @ v) * rs


def _split_heads(t: torch.Tensor, parts: int, num_heads: int):
    """(B, nW, N, parts*h*d) -> `parts` tensors (B, nW, h, N, d)."""
    B, nW, N, Cp = t.shape
    t = t.reshape(B, nW, N, parts, num_heads, Cp // (parts * num_heads))
    return t.permute(3, 0, 1, 4, 2, 5).unbind(0)


def _project(x, wqkv, bqkv, num_heads, mm, parts):
    """(B, nW, N, C) tokens -> `parts` projections (B, nW, h, N, d) in
    fp32 with operands rounded to mm."""
    t = x.float() @ wqkv.to(mm).float()
    if bqkv is not None:
        t = t + bqkv.float()
    return _split_heads(t, parts, num_heads)


def _check_inference(name: str, *tensors) -> None:
    """Raise under grad for a kernel without a backward (B5-B7: the JAX
    package has no VJP for them either)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet; run under "
            "torch.no_grad() or pass kernels=False")


class _PlainGrad(torch.autograd.Function):
    """Forward: a kernel's launch.  Backward: autograd of its plain version,
    re-run on detached copies of the same inputs (the JAX package's custom
    VJPs around B1-B4 recompute their XLA twins the same way)."""

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.args = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.slots))
        return launch(*args)

    @staticmethod
    def backward(ctx, gy):
        args = list(ctx.args)
        wanted = []
        for i, t in zip(ctx.slots, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(ctx.needs_input_grad[2 + i])
            if ctx.needs_input_grad[2 + i]:
                wanted.append(i)
        with torch.enable_grad():
            y = ctx.plain(*args)
            grads = torch.autograd.grad(y, [args[i] for i in wanted], gy,
                                        allow_unused=True)
        out = [None] * len(args)
        for i, g in zip(wanted, grads):
            out[i] = g
        return (None, None, *out)


def _launch(launch, plain, *args):
    """launch(*args), differentiable through plain when grad mode is on and
    a tensor argument requires grad."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return _PlainGrad.apply(launch, plain, *args)
    return launch(*args)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operands(x, wqkv, bqkv, logit_scales, biases, bands,
              bias_dtype=torch.float32, parts: Optional[Tuple[int, int]] = None):
    """Contiguous kernel operands on x's device but w (`_kernel_w`): x,
    the fp32 bias vector and scales, position biases in bias_dtype, int32
    band ids.  With parts = (p0, n), for the tensor-core routes of B2-B4:
    the bias vector holds the values of parts p0..p0+n."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    C3 = wqkv.shape[1]
    b = (torch.zeros(C3, device=x.device) if bqkv is None
         else bqkv.float().contiguous())
    if b.numel() != C3:
        raise ValueError(f"bqkv has {b.numel()} values, wqkv {C3} columns")
    for t in (wqkv, b, *logit_scales, *biases, *bands):
        if t is not None and t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    if parts is not None:
        p0, n = parts
        b = b[p0 * C3 // 3:(p0 + n) * C3 // 3]
    return (x.contiguous(), b,
            [_scale(s).contiguous() for s in logit_scales],
            [t.to(bias_dtype).contiguous() for t in biases],
            [None if t is None else t.to(torch.int32).contiguous()
             for t in bands])


def _kernel_w(wqkv, x, parts: Optional[Tuple[int, int]] = None):
    """w as a CUDA-core kernel reads it (x's type, contiguous) or, with
    parts, as a tensor-core projection of B2-B4 reads it (`_pack_w`)."""
    return wqkv.to(x.dtype).contiguous() if parts is None else _pack_w(wqkv, *parts)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ----------------------------------------------------------------- windows

def window_half_ref(x, wqkv, bqkv, logit_scale, bias, window: Size2,
                    bands=None, shift: int = 0) -> torch.Tensor:
    """Plain PyTorch window half (twin of `_window_half_ref_xla`).

    x: (B, H, W, C) fp32/bf16, unrolled; wqkv: (C, 3Cw) this half's slice of
    the shared projection; bqkv: (3Cw,) or None; logit_scale: (h, 1, 1);
    bias: (h, N, N) fp32; bands: (nW, N) int or None; shift: the cyclic
    window shift.  Returns (B, H, W, Cw) in x's type, rolled coordinates."""
    mm = x.dtype
    B, H, W, _ = x.shape
    h = logit_scale.shape[0]
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    q, k, v = _project(window_partition(x, window), wqkv, bqkv, h, mm, 3)
    s = _scale(logit_scale).reshape(h, 1, 1)
    q = (_unit(q) * s).to(mm).float()
    k = _unit(k).to(mm).float()
    attn = q @ k.transpose(-1, -2) + bias.float()
    if bands is not None:
        attn = attn + _band_mask(bands, bands)
    y = _softmax_times(attn, v.to(mm).float(), mm)   # (B, nW, h, N, d)
    B, nW, _, N, d = y.shape
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nW, N, h * d)
    return window_reverse(y, window, (H, W)).to(x.dtype)


def window_half_large_ref(x, wqkv, bqkv, logit_scale, bias, window: Size2,
                          bands=None, shift: int = 0) -> torch.Tensor:
    """Plain PyTorch large-window half, the numerics of B3 (the q-tiled
    branch of `_window_block_kernel`): B1's math with the bias rounded to
    bf16 whatever x's type (`pack_window_bias(..., out_dtype=bf16)`).
    Arguments as in `window_half_ref`."""
    return window_half_ref(x, wqkv, bqkv, logit_scale,
                           bias.to(torch.bfloat16).float(), window, bands,
                           shift)


def _check_window(name, x, wqkv, logit_scale, bias, window, bands):
    B, H, W, C = x.shape
    wh, ww = window
    h = logit_scale.shape[0]
    Cw = wqkv.shape[1] // 3
    N = wh * ww
    if wqkv.shape[0] != C or Cw % h or tuple(bias.shape) != (h, N, N):
        raise ValueError(f"{name}: wqkv {tuple(wqkv.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit x {tuple(x.shape)}")
    nW = (H // wh) * (W // ww)
    if bands is not None and tuple(bands.shape) != (nW, N):
        raise ValueError(f"{name}: bands {tuple(bands.shape)} != {(nW, N)}")
    return B, H, W, C, Cw, h


def _window_work(x, wqkv, bqkv, logit_scale, bias, window: Size2, bands=None):
    """B1's and B3's work for `profiling.cost_analysis`: the products' FLOPs
    as torch's FlopCounterMode counts them in the plain version (the qkv
    projection, the logits, the weighted sum), and each operand read once,
    y written once."""
    B, H, W, C = x.shape
    cw = wqkv.shape[1] // 3
    t, n = B * H * W, window[0] * window[1]
    return (2 * t * C * 3 * cw + 4 * t * n * cw,
            tensor_bytes(x, wqkv, bqkv, logit_scale, bias, bands) + t * cw * x.element_size())


def _stripe_work(parts: int, steps: int, out, x, anchor, wqkv, bqkv, logit_scales,
                 biases, stripe: Size2, df: int, bands=None, bands_a=None, x1=None):
    """B2's and the B4 steps' work, as `_window_work`: `parts` of q, k, v
    projected, `steps` of the two anchor attentions, output `out`."""
    B, H, W, C = x.shape
    cs = wqkv.shape[1] // 3
    t, n2 = B * H * W, (stripe[0] // df) * (stripe[1] // df)
    return (2 * t * C * parts * cs + 4 * steps * t * n2 * cs,
            tensor_bytes(x, anchor, wqkv, bqkv, *logit_scales, *biases, bands, bands_a,
                         x1, out))


def window_half(x, wqkv, bqkv, logit_scale, bias, window: Size2, bands=None,
                shift: int = 0, kernels: bool = True) -> torch.Tensor:
    """Window half, routed as the TPU routes it: small windows to B1,
    windows of more than 512 tokens to B3 (`window_half_large`).  Each
    route launches its CUDA kernels for a CUDA x (B1: one fused kernel on
    tensor cores for bf16, head dims up to 64; the CUDA-core kernel for
    fp32) and runs its plain version for a CPU x or when kernels=False.
    Arguments as in `window_half_ref`."""
    B, H, W, C = x.shape
    h = logit_scale.shape[0]
    route = window_route((H, W), window, h)
    if route is None:
        raise NotImplementedError(
            f"window_half: no TPU window kernel takes window {window} on "
            f"{H}x{W} with {h} heads")
    args = (x, wqkv, bqkv, logit_scale, bias, window, bands, shift)
    if route == "large":
        return window_half_large(*args, kernels)
    if not kernels or not x.is_cuda:
        return window_half_ref(*args)
    return _launch(_window_half_kernel, window_half_ref, *args)


def _window_half_kernel(x, wqkv, bqkv, logit_scale, bias, window: Size2,
                        bands=None, shift: int = 0) -> torch.Tensor:
    B, H, W, C, Cw, h = _check_window("window_half", x, wqkv, logit_scale,
                                      bias, window, bands)
    wh, ww = window
    d = Cw // h
    tc = x.dtype == torch.bfloat16
    x, b, (s,), (bias,), (bands,) = _operands(
        x, wqkv, bqkv, [logit_scale], [bias], [bands])
    y = torch.empty((B, H, W, Cw), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    if tc:
        _check_d("window_half", d)
        # the tensor-core kernel reads w where the model keeps it (fp32 or
        # bf16, any strides) and rounds it to bf16 in shared memory
        w = wqkv
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"wqkv must be float32 or bfloat16, got {w.dtype}")
        err = lib.grlir_window_half_mma(
            _ptr(x), _ptr(w), w.stride(0), w.stride(1),
            int(w.dtype == torch.bfloat16), _ptr(b), _ptr(s), _ptr(bias),
            _ptr(bands), _ptr(y), B, H, W, C, Cw, h, wh, ww, int(shift),
            _stream(x))
    else:
        w = _kernel_w(wqkv, x)
        err = lib.grlir_window_half(
            _ptr(x), _ptr(w), _ptr(b), _ptr(s), _ptr(bias), _ptr(bands),
            _ptr(y), B, H, W, C, Cw, h, wh, ww, int(shift), _stream(x))
    cuda_build.check(err, "window_half", f"window {window} at d={d}")
    _count_route(window_half, x)
    kernel_work(_window_work, x, wqkv, bqkv, logit_scale, bias, window, bands)
    return y


window_half.launches = 0
window_half.route_launches = {"tensor_core": 0, "cuda_core": 0}

# head dims the kernels take (B1-B4's tensor-core routes, B3's and B4's
# CUDA-core routes, and B5, which runs B4's attention kernel): their rows
# are padded to 32 columns, or to 64 above 32 (`_head_cols`)
MAX_D = 64


def _check_d(name: str, d: int) -> None:
    if d > MAX_D:
        raise NotImplementedError(
            f"{name}: head dim {d} > {MAX_D} is beyond the kernel's tiles")


def _head_cols(d: int) -> int:
    """Columns of a tensor-core workspace row of head dim d (zeros past d)."""
    return 32 if d <= 32 else 64


def window_half_large(x, wqkv, bqkv, logit_scale, bias, window: Size2,
                      bands=None, shift: int = 0,
                      kernels: bool = True) -> torch.Tensor:
    """Large-window half (B3): the CUDA kernels of
    `csrc/window_half_large.cu` for a CUDA x (tensor cores for bf16, CUDA
    cores for fp32), `window_half_large_ref` for a CPU x or when
    kernels=False.  Arguments as in `window_half_ref`."""
    args = (x, wqkv, bqkv, logit_scale, bias, window, bands, shift)
    if not kernels or not x.is_cuda:
        return window_half_large_ref(*args)
    return _launch(_window_half_large_kernel, window_half_large_ref, *args)


def _window_half_large_kernel(x, wqkv, bqkv, logit_scale, bias, window: Size2,
                              bands=None, shift: int = 0) -> torch.Tensor:
    B, H, W, C, Cw, h = _check_window("window_half_large", x, wqkv,
                                      logit_scale, bias, window, bands)
    wh, ww = window
    N, d = wh * ww, Cw // h
    _check_d("window_half_large", d)
    tc = x.dtype == torch.bfloat16
    parts = (0, 3) if tc else None
    w = _kernel_w(wqkv, x, parts)
    x, b, (s,), (bias,), (bands,) = _operands(
        x, wqkv, bqkv, [logit_scale], [bias], [bands],
        bias_dtype=torch.bfloat16, parts=parts)
    nW = (H // wh) * (W // ww)
    y = torch.empty((B, H, W, Cw), dtype=x.dtype, device=x.device)
    geom = (B, H, W, C, Cw, h, wh, ww, int(shift))
    lib = cuda_build.library()
    # q (unit-normed, times the scale), k (unit-normed) and v of every
    # window and head, rounded to x's type: in rows of 32 or 64 for bf16
    if tc:
        ws = torch.empty((B * nW, h, 3, N, _head_cols(d)), dtype=x.dtype,
                         device=x.device)
        err = lib.grlir_window_half_large_mma(
            _ptr(x), _ptr(w), _ptr(b), _ptr(s), _ptr(bias), _ptr(bands),
            _ptr(ws), _ptr(y), *geom, w.shape[1], _stream(x))
    else:
        ws = torch.empty((B * nW, h, 3, N, d), dtype=x.dtype, device=x.device)
        err = lib.grlir_window_half_large(
            _ptr(x), _ptr(w), _ptr(b), _ptr(s), _ptr(bias), _ptr(bands),
            _ptr(ws), _ptr(y), *geom, _stream(x))
    cuda_build.check(err, "window_half_large", f"window {window} at d={d}")
    _count_route(window_half_large, x)
    kernel_work(_window_work, x, wqkv, bqkv, logit_scale, bias, window, bands)
    return y


window_half_large.launches = 0
window_half_large.route_launches = {"tensor_core": 0, "cuda_core": 0}


# ----------------------------------------------------------------- stripes

def stripe_half_ref(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2,
                    bias_a2w, bias_w2a, stripe: Size2, df: int, bands=None,
                    bands_a=None, shift: Size2 = (0, 0)) -> torch.Tensor:
    """Plain PyTorch anchored-stripe half (twin of `_stripe_half_ref_xla`).

    x: (B, H, W, C), unrolled; anchor: (B, H/df, W/df, Cs), already rolled
    by the caller; wqkv: (C, 3Cs); bias_a2w: (h, N2, N1); bias_w2a:
    (h, N1, N2); bands/bands_a: (nW, N1)/(nW, N2) or None; shift: the cyclic
    stripe shift of x.  Returns (B, H, W, Cs), rolled coordinates."""
    mm = x.dtype
    B, H, W, _ = x.shape
    h = logit_scale1.shape[0]
    sh, sw = stripe
    if shift[0] or shift[1]:
        x = torch.roll(x, (-shift[0], -shift[1]), dims=(1, 2))
    q, k, v = _project(window_partition(x, stripe), wqkv, bqkv, h, mm, 3)
    an = _anchor_units(anchor, stripe, df, h, mm)          # (B, nW, h, N2, d)
    kn = (_unit(k) * _scale(logit_scale1).reshape(h, 1, 1)).to(mm).float()
    qn = (_unit(q) * _scale(logit_scale2).reshape(h, 1, 1)).to(mm).float()
    attn1 = an @ kn.transpose(-1, -2) + bias_a2w.float()      # (.., h, N2, N1)
    attn2 = qn @ an.transpose(-1, -2) + bias_w2a.float()      # (.., h, N1, N2)
    if bands is not None:
        attn1 = attn1 + _band_mask(bands_a, bands)
        attn2 = attn2 + _band_mask(bands, bands_a)
    x1 = _softmax_times(attn1, v.to(mm).float(), mm)          # (.., h, N2, d)
    y = _softmax_times(attn2, x1.to(mm).float(), mm)          # (.., h, N1, d)
    return _stripe_out(y, stripe, (H, W)).to(x.dtype)


def _anchor_units(anchor, stripe: Size2, df: int, num_heads: int, mm):
    """Anchor tokens of every stripe, unit-normed and rounded to mm:
    (B, nW, h, N2, d) fp32."""
    sh, sw = stripe
    a = window_partition(anchor.to(mm), (sh // df, sw // df)).float()
    B, nW, N2, Cs = a.shape
    a = a.reshape(B, nW, N2, num_heads, Cs // num_heads).permute(0, 1, 3, 2, 4)
    return _unit(a).to(mm).float()


def _stripe_out(y, stripe: Size2, x_size: Size2):
    """(B, nW, h, N1, d) -> (B, H, W, h*d)."""
    B, nW, h, N1, d = y.shape
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nW, N1, h * d)
    return window_reverse(y, stripe, x_size)


def _roll_stripe_tokens(x, stripe: Size2, shift: Size2):
    if shift[0] or shift[1]:
        x = torch.roll(x, (-shift[0], -shift[1]), dims=(1, 2))
    return window_partition(x, stripe)


def stripe_a2w_large_ref(x, anchor, wqkv, bqkv, logit_scale1, bias_a2w,
                         stripe: Size2, df: int, bands=None, bands_a=None,
                         shift: Size2 = (0, 0)) -> torch.Tensor:
    """Plain PyTorch a2w step of the streamed-bias stripe half, the numerics
    of B4a (`_stripe_a2w_large_kernel`): every anchor token gathers its
    stripe, x1 = softmax_N1(norm(a) . norm(k)^T * s1 + bias + mask) v, with
    the bias in x's type and the softmax normalised before it is rounded.
    Arguments as in `stripe_half_ref`.  Returns x1 (B, nW, h, N2, d) in x's
    type."""
    mm = x.dtype
    h = logit_scale1.shape[0]
    Cs = wqkv.shape[1] // 3
    k, v = _project(_roll_stripe_tokens(x, stripe, shift), wqkv[:, Cs:],
                    None if bqkv is None else bqkv[Cs:], h, mm, 2)
    an = _anchor_units(anchor, stripe, df, h, mm)
    kn = _unit(k).to(mm).float()
    attn = an @ kn.transpose(-1, -2)                          # (.., h, N2, N1)
    attn = attn * _scale(logit_scale1).reshape(h, 1, 1) + bias_a2w.to(mm).float()
    if bands is not None:
        attn = attn + _band_mask(bands_a, bands)
    p = torch.softmax(attn, -1).to(mm).float()
    return (p @ v.to(mm).float()).to(mm)


def stripe_w2a_large_ref(x, anchor, x1, wqkv, bqkv, logit_scale2, bias_w2a,
                         stripe: Size2, df: int, bands=None, bands_a=None,
                         shift: Size2 = (0, 0)) -> torch.Tensor:
    """Plain PyTorch w2a step of the streamed-bias stripe half, the numerics
    of B4b (`_stripe_w2a_large_kernel`): every stripe token takes
    y = softmax_N2(norm(q) . norm(a)^T * s2 + bias + mask) x1, with the
    bias in x's type and the softmax normalised before it is rounded.
    x1: (B, nW, h, N2, d) from the a2w step; other arguments as in
    `stripe_half_ref`.  Returns (B, H, W, Cs), rolled coordinates."""
    mm = x.dtype
    B, H, W, _ = x.shape
    h = logit_scale2.shape[0]
    Cs = wqkv.shape[1] // 3
    (q,) = _project(_roll_stripe_tokens(x, stripe, shift), wqkv[:, :Cs],
                    None if bqkv is None else bqkv[:Cs], h, mm, 1)
    an = _anchor_units(anchor, stripe, df, h, mm)
    qn = _unit(q).to(mm).float()
    attn = qn @ an.transpose(-1, -2)                          # (.., h, N1, N2)
    attn = attn * _scale(logit_scale2).reshape(h, 1, 1) + bias_w2a.to(mm).float()
    if bands is not None:
        attn = attn + _band_mask(bands, bands_a)
    p = torch.softmax(attn, -1).to(mm).float()
    y = p @ x1.to(mm).float()                                 # (.., h, N1, d)
    return _stripe_out(y, stripe, (H, W)).to(x.dtype)


def stripe_half_large_ref(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2,
                          bias_a2w, bias_w2a, stripe: Size2, df: int,
                          bands=None, bands_a=None,
                          shift: Size2 = (0, 0)) -> torch.Tensor:
    """Plain PyTorch streamed-bias stripe half (B4): the a2w step, then the
    w2a step.  Arguments as in `stripe_half_ref`."""
    x1 = stripe_a2w_large_ref(x, anchor, wqkv, bqkv, logit_scale1, bias_a2w,
                              stripe, df, bands, bands_a, shift)
    return stripe_w2a_large_ref(x, anchor, x1, wqkv, bqkv, logit_scale2,
                                bias_w2a, stripe, df, bands, bands_a, shift)


def _check_stripe(name, x, anchor, wqkv, logit_scale, stripe, df, bands,
                  bands_a, bias_a2w=None, bias_w2a=None, x1=None):
    """Shapes of a stripe call (the given biases and x1 included)."""
    B, H, W, C = x.shape
    sh, sw = stripe
    h = logit_scale.shape[0]
    Cs = wqkv.shape[1] // 3
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    nW = (H // sh) * (W // sw)
    want = [(bias_a2w, (h, N2, N1)), (bias_w2a, (h, N1, N2)),
            (x1, (B, nW, h, N2, Cs // h))]
    if (wqkv.shape[0] != C or Cs % h
            or tuple(anchor.shape) != (B, H // df, W // df, Cs)
            or any(t is not None and tuple(t.shape) != s for t, s in want)):
        raise ValueError(f"{name}: operand shapes do not fit x "
                         f"{tuple(x.shape)}, stripe {stripe}, df {df}")
    if (bands is None) != (bands_a is None):
        raise ValueError(f"{name}: pass both bands and bands_a, or neither")
    if bands is not None and (tuple(bands.shape) != (nW, N1)
                              or tuple(bands_a.shape) != (nW, N2)):
        raise ValueError(f"{name}: band ids do not fit the stripes")
    for t in (anchor, x1):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operand on {t.device}, x on {x.device}")
    return B, H, W, C, Cs, h, N1, N2, nW


def stripe_half(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2, bias_a2w,
                bias_w2a, stripe: Size2, df: int, bands=None, bands_a=None,
                shift: Size2 = (0, 0), kernels: bool = True) -> torch.Tensor:
    """Anchored-stripe half, routed as the TPU routes it: stripes whose
    biases fit the resident budget to B2 (the kernels of
    `csrc/stripe_half.cu`: tensor cores for bf16, CUDA cores for fp32),
    larger ones to the two B4 steps (`stripe_a2w_large`, then
    `stripe_w2a_large`).  Each launches its CUDA kernels for a CUDA x and
    runs its plain version for a CPU x or when kernels=False.  Arguments as
    in `stripe_half_ref`."""
    B, H, W, C = x.shape
    h = logit_scale1.shape[0]
    route = stripe_route((H, W), stripe, df, h)
    if route is None:
        raise NotImplementedError(
            f"stripe_half: no TPU stripe kernel takes stripe {stripe}/df "
            f"{df} on {H}x{W} with {h} heads")
    args = (x, anchor, wqkv, bqkv, logit_scale1, logit_scale2, bias_a2w,
            bias_w2a, stripe, df, bands, bands_a, shift)
    plain = stripe_half_large_ref if route == "large" else stripe_half_ref
    if not kernels or not x.is_cuda:
        return plain(*args)
    # B4's two steps under one backward, as the JAX package's custom VJP
    # wraps the pair (grlir/ops/pallas/block_attn.py:1287-1310): the w2a
    # step's backward must see the plain x1, not the kernel's
    launch = _stripe_half_large_kernel if route == "large" else _stripe_half_kernel
    return _launch(launch, plain, *args)


def _stripe_half_large_kernel(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2,
                              bias_a2w, bias_w2a, stripe: Size2, df: int,
                              bands=None, bands_a=None,
                              shift: Size2 = (0, 0)) -> torch.Tensor:
    x1 = _stripe_a2w_large_kernel(x, anchor, wqkv, bqkv, logit_scale1, bias_a2w,
                                  stripe, df, bands, bands_a, shift)
    return _stripe_w2a_large_kernel(x, anchor, x1, wqkv, bqkv, logit_scale2,
                                    bias_w2a, stripe, df, bands, bands_a, shift)


def _stripe_half_kernel(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2,
                        bias_a2w, bias_w2a, stripe: Size2, df: int, bands=None,
                        bands_a=None, shift: Size2 = (0, 0)) -> torch.Tensor:
    sh, sw = stripe
    B, H, W, C, Cs, h, N1, N2, nW = _check_stripe(
        "stripe_half", x, anchor, wqkv, logit_scale1, stripe, df, bands,
        bands_a, bias_a2w, bias_w2a)
    tc = x.dtype == torch.bfloat16
    if tc:   # the tensor-core route's workspace rows hold 32 or 64 columns
        _check_d("stripe_half", Cs // h)
    parts = (0, 3) if tc else None
    w = _kernel_w(wqkv, x, parts)
    x, b, (s1, s2), (b1, b2), (bands, bands_a) = _operands(
        x, wqkv, bqkv, [logit_scale1, logit_scale2], [bias_a2w, bias_w2a],
        [bands, bands_a], parts=parts)
    anchor = anchor.to(x.dtype).contiguous()
    y = torch.empty((B, H, W, Cs), dtype=x.dtype, device=x.device)
    geom = (B, H, W, C, Cs, h, sh, sw, df, int(shift[0]), int(shift[1]))
    lib = cuda_build.library()
    if tc:
        # q (unit-normed, times s2), k (unit-normed, times s1) and v of
        # every stripe, in rows of 32 or 64
        ws = torch.empty((B * nW, h, 3, N1, _head_cols(Cs // h)),
                         dtype=x.dtype, device=x.device)
        err = lib.grlir_stripe_half_mma(
            _ptr(x), _ptr(anchor), _ptr(w), _ptr(b), _ptr(s1), _ptr(s2),
            _ptr(b1), _ptr(b2), _ptr(bands), _ptr(bands_a), _ptr(ws), _ptr(y),
            *geom, w.shape[1], _stream(x))
    else:
        err = lib.grlir_stripe_half(
            _ptr(x), _ptr(anchor), _ptr(w), _ptr(b), _ptr(s1), _ptr(s2),
            _ptr(b1), _ptr(b2), _ptr(bands), _ptr(bands_a), _ptr(y), *geom,
            _stream(x))
    cuda_build.check(err, "stripe_half", f"stripe {stripe}/df {df} at "
                     f"d={Cs // h}")
    _count_route(stripe_half, x)
    kernel_work(_stripe_work, 3, 2, y, x, anchor, wqkv, bqkv, (s1, s2), (b1, b2),
                stripe, df, bands, bands_a)
    return y


stripe_half.launches = 0
stripe_half.route_launches = {"tensor_core": 0, "cuda_core": 0}


def _pack_w(w, p0: int, nparts: int) -> torch.Tensor:
    """Parts p0..p0+nparts (q, k, v = 0, 1, 2) of w (C, 3Cs) as the
    tensor-core projection reads them: transposed, one row of C bf16 values
    an output column, the rows Cp apart (C rounded up to a multiple of 16)
    so that each starts 16-byte aligned: (nparts*Cs, Cp).  The kernel pads
    each head to 32 columns itself and reads the first C values of a row;
    the rest are left unset.  Packed on every call from the w it is given,
    so every write to the weights is seen."""
    C, C3 = w.shape
    Cs = C3 // 3
    wt = torch.empty((nparts * Cs, -(-C // 16) * 16), dtype=torch.bfloat16,
                     device=w.device)
    wt[:, :C].copy_(w[:, p0 * Cs:(p0 + nparts) * Cs].t())
    return wt


def _count_route(fn, x: torch.Tensor) -> None:
    """One launch of B1, B2, B3, a B4 step or B5 on the route x's type
    takes: bf16 on tensor cores, fp32 on CUDA cores."""
    fn.launches += 1
    fn.route_launches[
        "tensor_core" if x.dtype == torch.bfloat16 else "cuda_core"] += 1


def stripe_a2w_large(x, anchor, wqkv, bqkv, logit_scale1, bias_a2w,
                     stripe: Size2, df: int, bands=None, bands_a=None,
                     shift: Size2 = (0, 0), kernels: bool = True) -> torch.Tensor:
    """a2w step of the streamed-bias stripe half (B4a): the CUDA kernels of
    `csrc/stripe_half_large.cu` for a CUDA x (tensor cores for bf16, CUDA
    cores for fp32), `stripe_a2w_large_ref` for a CPU x or when
    kernels=False.  Returns x1 (B, nW, h, N2, d) in x's type."""
    args = (x, anchor, wqkv, bqkv, logit_scale1, bias_a2w, stripe, df, bands,
            bands_a, shift)
    if not kernels or not x.is_cuda:
        return stripe_a2w_large_ref(*args)
    return _launch(_stripe_a2w_large_kernel, stripe_a2w_large_ref, *args)


def _stripe_a2w_large_kernel(x, anchor, wqkv, bqkv, logit_scale1, bias_a2w,
                             stripe: Size2, df: int, bands=None, bands_a=None,
                             shift: Size2 = (0, 0)) -> torch.Tensor:
    sh, sw = stripe
    B, H, W, C, Cs, h, N1, N2, nW = _check_stripe(
        "stripe_a2w_large", x, anchor, wqkv, logit_scale1, stripe, df, bands,
        bands_a, bias_a2w=bias_a2w)
    d = Cs // h
    _check_d("stripe_a2w_large", d)
    tc = x.dtype == torch.bfloat16
    parts = (1, 2) if tc else None
    w = _kernel_w(wqkv, x, parts)
    x, b, (s1,), (b1,), (bands, bands_a) = _operands(
        x, wqkv, bqkv, [logit_scale1], [bias_a2w], [bands, bands_a],
        bias_dtype=x.dtype, parts=parts)
    anchor = anchor.to(x.dtype).contiguous()
    geom = (B, H, W, C, Cs, h, sh, sw, df, int(shift[0]), int(shift[1]))
    x1 = torch.empty((B, nW, h, N2, d), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    if tc:
        # unit-normed anchors, then k (unit-normed) and v of every stripe,
        # in rows of 32 or 64
        dp = _head_cols(d)
        ws_an = torch.empty((B * nW, h, N2, dp), dtype=x.dtype, device=x.device)
        ws_kv = torch.empty((B * nW, h, 2, N1, dp), dtype=x.dtype,
                            device=x.device)
        err = lib.grlir_stripe_a2w_large_mma(
            _ptr(x), _ptr(anchor), _ptr(w), _ptr(b), _ptr(s1), _ptr(b1),
            _ptr(bands), _ptr(bands_a), _ptr(ws_an), _ptr(ws_kv), _ptr(x1),
            *geom, w.shape[1], _stream(x))
    else:
        ws_an = torch.empty((B * nW, h, N2, d), dtype=x.dtype, device=x.device)
        ws_kv = torch.empty((B * nW, h, 2, N1, d), dtype=x.dtype,
                            device=x.device)
        err = lib.grlir_stripe_a2w_large(
            _ptr(x), _ptr(anchor), _ptr(w), _ptr(b), _ptr(s1), _ptr(b1),
            _ptr(bands), _ptr(bands_a), _ptr(ws_an), _ptr(ws_kv), _ptr(x1),
            *geom, _stream(x))
    cuda_build.check(err, "stripe_a2w_large", f"stripe {stripe}/df {df}")
    _count_route(stripe_a2w_large, x)
    kernel_work(_stripe_work, 2, 1, x1, x, anchor, wqkv, bqkv, (s1,), (b1,), stripe,
                df, bands, bands_a)
    return x1


stripe_a2w_large.launches = 0
stripe_a2w_large.route_launches = {"tensor_core": 0, "cuda_core": 0}


def stripe_w2a_large(x, anchor, x1, wqkv, bqkv, logit_scale2, bias_w2a,
                     stripe: Size2, df: int, bands=None, bands_a=None,
                     shift: Size2 = (0, 0), kernels: bool = True) -> torch.Tensor:
    """w2a step of the streamed-bias stripe half (B4b): the CUDA kernels of
    `csrc/stripe_half_large.cu` for a CUDA x (tensor cores for bf16, CUDA
    cores for fp32), `stripe_w2a_large_ref` for a CPU x or when
    kernels=False.  x1 is the a2w step's output.  Returns (B, H, W, Cs),
    rolled coordinates."""
    args = (x, anchor, x1, wqkv, bqkv, logit_scale2, bias_w2a, stripe, df,
            bands, bands_a, shift)
    if not kernels or not x.is_cuda:
        return stripe_w2a_large_ref(*args)
    return _launch(_stripe_w2a_large_kernel, stripe_w2a_large_ref, *args)


def _stripe_w2a_large_kernel(x, anchor, x1, wqkv, bqkv, logit_scale2, bias_w2a,
                             stripe: Size2, df: int, bands=None, bands_a=None,
                             shift: Size2 = (0, 0)) -> torch.Tensor:
    sh, sw = stripe
    B, H, W, C, Cs, h, N1, N2, nW = _check_stripe(
        "stripe_w2a_large", x, anchor, wqkv, logit_scale2, stripe, df, bands,
        bands_a, bias_w2a=bias_w2a, x1=x1)
    d = Cs // h
    _check_d("stripe_w2a_large", d)
    tc = x.dtype == torch.bfloat16
    parts = (0, 1) if tc else None
    w = _kernel_w(wqkv, x, parts)
    x, b, (s2,), (b2,), (bands, bands_a) = _operands(
        x, wqkv, bqkv, [logit_scale2], [bias_w2a], [bands, bands_a],
        bias_dtype=x.dtype, parts=parts)
    anchor = anchor.to(x.dtype).contiguous()
    x1 = x1.to(x.dtype).contiguous()
    geom = (B, H, W, C, Cs, h, sh, sw, df, int(shift[0]), int(shift[1]))
    y = torch.empty((B, H, W, Cs), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    if tc:
        # unit-normed anchors, unit-normed q of every stripe and x1, in rows
        # of 32 or 64
        dp = _head_cols(d)
        ws_an = torch.empty((B * nW, h, N2, dp), dtype=x.dtype, device=x.device)
        ws_q = torch.empty((B * nW, h, 1, N1, dp), dtype=x.dtype,
                           device=x.device)
        ws_x1 = torch.empty_like(ws_an)
        err = lib.grlir_stripe_w2a_large_mma(
            _ptr(x), _ptr(anchor), _ptr(x1), _ptr(w), _ptr(b), _ptr(s2),
            _ptr(b2), _ptr(bands), _ptr(bands_a), _ptr(ws_an), _ptr(ws_q),
            _ptr(ws_x1), _ptr(y), *geom, w.shape[1], _stream(x))
    else:
        ws_an = torch.empty((B * nW, h, N2, d), dtype=x.dtype, device=x.device)
        ws_q = torch.empty((B * nW, h, 1, N1, d), dtype=x.dtype,
                           device=x.device)
        err = lib.grlir_stripe_w2a_large(
            _ptr(x), _ptr(anchor), _ptr(x1), _ptr(w), _ptr(b), _ptr(s2),
            _ptr(b2), _ptr(bands), _ptr(bands_a), _ptr(ws_an), _ptr(ws_q),
            _ptr(y), *geom, _stream(x))
    cuda_build.check(err, "stripe_w2a_large", f"stripe {stripe}/df {df}")
    _count_route(stripe_w2a_large, x)
    kernel_work(_stripe_work, 1, 1, y, x, anchor, wqkv, bqkv, (s2,), (b2,), stripe,
                df, bands, bands_a, x1)
    return y


stripe_w2a_large.launches = 0
stripe_w2a_large.route_launches = {"tensor_core": 0, "cuda_core": 0}

KERNELS = (window_half, stripe_half, window_half_large, stripe_a2w_large,
           stripe_w2a_large)

# block halves whose geometry no route takes (window_route/stripe_route
# None) and that the model ran on its plain cosine attention instead, as
# the JAX package runs its XLA path there (grlir/models/blocks.py:557-562)
unrouted_halves = 0


# the kernels with a tensor-core and a CUDA-core route
ROUTED = (window_half, window_half_large, stripe_half, stripe_a2w_large,
          stripe_w2a_large)


# every kernel wrapper of the package that counts its launches: B1-B4
# here; B5 (ops/flash_attention.py) and B6/B7 (ops/attention.py) add
# theirs when imported, as they import this module
COUNTED = list(KERNELS)


def reset_launches() -> None:
    """Set the launch count of every kernel in COUNTED (a kernel of a
    module not imported yet counts 0 already), the counts by route of
    B1-B5 and unrouted_halves to 0."""
    global unrouted_halves
    for k in COUNTED:
        k.launches = 0
        for route in getattr(k, "route_launches", ()):
            k.route_launches[route] = 0
    unrouted_halves = 0
