"""Whole block-half attention: NHWC x in, NHWC attention output out.

Torch counterparts of `fused_window_half` and `fused_stripe_half`
(grlir/ops/pallas/block_attn.py).  Each half has a hand-written CUDA kernel
(`grlir_torch/csrc/window_half.cu`, `stripe_half.cu`) and, beside it, a plain
PyTorch version of the same function (`window_half_ref`, `stripe_half_ref`).

Dispatch (`kernels=True`, the default): a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version.  `kernels=False` runs the plain
version on any device.  The kernels have no backward yet, so with
`kernels=True` an input that requires grad under grad mode raises.

Both versions pin the numerics of the TPU kernels: q and k are unit-normed as
t * rsqrt(max(sum t^2, 1e-24)); the clamped logit scale exp(min(s, log 100))
is folded into q (window, w2a) or k (a2w) before the product; the shift mask
adds -100 where band ids differ; softmax is fp32 with the 1/sum applied after
the product with v; every product's operands are rounded to the input type
(bf16 when x is bf16) and summed in fp32.  Outputs are in rolled coordinates:
the caller un-rolls them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from grlir_torch.ops import cuda_build
from grlir_torch.ops.layout import window_partition, window_reverse

Size2 = Tuple[int, int]

# The TPU kernels' own admission rules, restated (block_attn.py:58-103):
# geometries beyond them belong to the large-window (B3) and streamed-bias
# large-stripe (B4) kernels, which are not ported yet.
_LARGE_N = 512
_BIAS_VMEM_BUDGET = 4 * 1024 * 1024


def _auto_pack_w(W: int, window: Size2) -> int:
    wh, ww = window
    pack_w = max(1, min(W // ww, -(-128 // (wh * ww)) * 2))
    while (W // ww) % pack_w:
        pack_w -= 1
    return pack_w


def window_half_supported(x_size: Size2, window: Size2, num_heads: int) -> bool:
    """True when the small-window TPU kernel (and so this port's) takes it."""
    H, W = x_size
    wh, ww = window
    if H % wh or W % ww or wh * ww > _LARGE_N:
        return False
    PN = _auto_pack_w(W, window) * wh * ww
    return num_heads * PN * PN * 4 <= _BIAS_VMEM_BUDGET


def stripe_half_supported(x_size: Size2, stripe: Size2, df: int,
                          num_heads: int) -> bool:
    """True when the resident-bias TPU stripe kernel (and so this port's)
    takes it."""
    H, W = x_size
    sh, sw = stripe
    if H % sh or W % sw or sh % df or sw % df:
        return False
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    return 2 * num_heads * N2 * N1 * 4 <= _BIAS_VMEM_BUDGET


def _scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """(h,) fp32 exp(min(logit_scale, log 100))."""
    s = torch.clamp(logit_scale.float(), max=math.log(100.0))
    return torch.exp(s).reshape(-1)


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t * torch.rsqrt(torch.clamp((t * t).sum(-1, keepdim=True),
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


def _qkv_heads(x: torch.Tensor, wqkv: torch.Tensor,
               bqkv: Optional[torch.Tensor], num_heads: int, mm: torch.dtype):
    """(B, nW, N, C) tokens -> q, k, v each (B, nW, h, N, d) in fp32, the
    projection's operands rounded to mm; channel order [3, heads, d]."""
    B, nW, N, _ = x.shape
    qkv = x.float() @ wqkv.to(mm).float()
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    C3 = qkv.shape[-1]
    qkv = qkv.reshape(B, nW, N, 3, num_heads, C3 // (3 * num_heads))
    return qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)


def _check_inference(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet; run under "
            "torch.no_grad() or pass kernels=False")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operands(x, wqkv, bqkv, logit_scales, biases, bands):
    """Contiguous kernel operands on x's device: w in x's type, fp32 bias
    vector, scales and position biases, int32 band ids."""
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
    return (x.contiguous(), wqkv.to(x.dtype).contiguous(), b,
            [_scale(s).contiguous() for s in logit_scales],
            [t.float().contiguous() for t in biases],
            [None if t is None else t.to(torch.int32).contiguous()
             for t in bands])


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
    q, k, v = _qkv_heads(window_partition(x, window), wqkv, bqkv, h, mm)
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
    q, k, v = _qkv_heads(window_partition(x, stripe), wqkv, bqkv, h, mm)
    a = window_partition(anchor.to(mm), (sh // df, sw // df)).float()
    Bq, nW, N2, Cs = a.shape
    a = a.reshape(Bq, nW, N2, h, Cs // h).permute(0, 1, 3, 2, 4)
    an = _unit(a).to(mm).float()                              # (B, nW, h, N2, d)
    kn = (_unit(k) * _scale(logit_scale1).reshape(h, 1, 1)).to(mm).float()
    qn = (_unit(q) * _scale(logit_scale2).reshape(h, 1, 1)).to(mm).float()
    attn1 = an @ kn.transpose(-1, -2) + bias_a2w.float()      # (.., h, N2, N1)
    attn2 = qn @ an.transpose(-1, -2) + bias_w2a.float()      # (.., h, N1, N2)
    if bands is not None:
        attn1 = attn1 + _band_mask(bands_a, bands)
        attn2 = attn2 + _band_mask(bands, bands_a)
    x1 = _softmax_times(attn1, v.to(mm).float(), mm)          # (.., h, N2, d)
    y = _softmax_times(attn2, x1.to(mm).float(), mm)          # (.., h, N1, d)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bq, nW, sh * sw, Cs)
    return window_reverse(y, stripe, (H, W)).to(x.dtype)


def window_half(x, wqkv, bqkv, logit_scale, bias, window: Size2, bands=None,
                shift: int = 0, kernels: bool = True) -> torch.Tensor:
    """Window half: the CUDA kernel for a CUDA x, the plain version for a
    CPU x or when kernels=False.  Arguments as in `window_half_ref`."""
    if not kernels:
        return window_half_ref(x, wqkv, bqkv, logit_scale, bias, window,
                               bands, shift)
    _check_inference("window_half", x, wqkv, bqkv, logit_scale, bias)
    if not x.is_cuda:
        return window_half_ref(x, wqkv, bqkv, logit_scale, bias, window,
                               bands, shift)
    B, H, W, C = x.shape
    wh, ww = window
    h = logit_scale.shape[0]
    Cw = wqkv.shape[1] // 3
    N = wh * ww
    if not window_half_supported((H, W), window, h):
        raise NotImplementedError(
            f"window_half: window {window} on {H}x{W} with {h} heads is "
            "beyond the small-window kernel; it needs the large-window "
            "kernel (ROADMAP B3), not ported yet")
    if wqkv.shape[0] != C or Cw % h or tuple(bias.shape) != (h, N, N):
        raise ValueError(f"window_half: wqkv {tuple(wqkv.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit x {tuple(x.shape)}")
    nW = (H // wh) * (W // ww)
    if bands is not None and tuple(bands.shape) != (nW, N):
        raise ValueError(f"window_half: bands {tuple(bands.shape)} != {(nW, N)}")
    x, w, b, (s,), (bias,), (bands,) = _operands(
        x, wqkv, bqkv, [logit_scale], [bias], [bands])
    y = torch.empty((B, H, W, Cw), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    err = lib.grlir_window_half(
        _ptr(x), _ptr(w), _ptr(b), _ptr(s), _ptr(bias), _ptr(bands), _ptr(y),
        B, H, W, C, Cw, h, wh, ww, int(shift), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "window_half",
                     f"window {window} at d={Cw // h} (a window that large "
                     "waits for the large-window kernel, ROADMAP B3)")
    window_half.launches += 1
    return y


window_half.launches = 0


def stripe_half(x, anchor, wqkv, bqkv, logit_scale1, logit_scale2, bias_a2w,
                bias_w2a, stripe: Size2, df: int, bands=None, bands_a=None,
                shift: Size2 = (0, 0), kernels: bool = True) -> torch.Tensor:
    """Anchored-stripe half: the CUDA kernel for a CUDA x, the plain version
    for a CPU x or when kernels=False.  Arguments as in `stripe_half_ref`."""
    args = (x, anchor, wqkv, bqkv, logit_scale1, logit_scale2, bias_a2w,
            bias_w2a, stripe, df, bands, bands_a, shift)
    if not kernels:
        return stripe_half_ref(*args)
    _check_inference("stripe_half", x, anchor, wqkv, bqkv, logit_scale1,
                     logit_scale2, bias_a2w, bias_w2a)
    if not x.is_cuda:
        return stripe_half_ref(*args)
    B, H, W, C = x.shape
    sh, sw = stripe
    h = logit_scale1.shape[0]
    Cs = wqkv.shape[1] // 3
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    if not stripe_half_supported((H, W), stripe, df, h):
        raise NotImplementedError(
            f"stripe_half: stripe {stripe}/df {df} on {H}x{W} with {h} heads "
            "is beyond the resident-bias kernel; it needs the streamed-bias "
            "large-stripe kernels (ROADMAP B4), not ported yet")
    nW = (H // sh) * (W // sw)
    if (wqkv.shape[0] != C or Cs % h
            or tuple(anchor.shape) != (B, H // df, W // df, Cs)
            or tuple(bias_a2w.shape) != (h, N2, N1)
            or tuple(bias_w2a.shape) != (h, N1, N2)):
        raise ValueError("stripe_half: operand shapes do not fit x "
                         f"{tuple(x.shape)}, stripe {stripe}, df {df}")
    if (bands is None) != (bands_a is None):
        raise ValueError("stripe_half: pass both bands and bands_a, or neither")
    if bands is not None and (tuple(bands.shape) != (nW, N1)
                              or tuple(bands_a.shape) != (nW, N2)):
        raise ValueError("stripe_half: band ids do not fit the stripes")
    x, w, b, (s1, s2), (b1, b2), (bands, bands_a) = _operands(
        x, wqkv, bqkv, [logit_scale1, logit_scale2], [bias_a2w, bias_w2a],
        [bands, bands_a])
    anchor = anchor.to(x.dtype).contiguous()
    if anchor.device != x.device:
        raise ValueError(f"anchor on {anchor.device}, x on {x.device}")
    y = torch.empty((B, H, W, Cs), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    err = lib.grlir_stripe_half(
        _ptr(x), _ptr(anchor), _ptr(w), _ptr(b), _ptr(s1), _ptr(s2), _ptr(b1),
        _ptr(b2), _ptr(bands), _ptr(bands_a), _ptr(y), B, H, W, C, Cs, h, sh,
        sw, df, int(shift[0]), int(shift[1]), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "stripe_half",
                     f"stripe {stripe}/df {df} at d={Cs // h} (waits for the "
                     "large-stripe kernels, ROADMAP B4)")
    stripe_half.launches += 1
    return y


stripe_half.launches = 0
