"""Fused cosine attention on q, k, v projected beforehand.

Torch counterparts of the window and stripe engines of
`grlir/ops/pallas/attention.py`, each a hand-written CUDA kernel with a
plain PyTorch version beside it:

  fused_window_attention_qkv (B6)     csrc/cosine_attention.cu  *_ref
  fused_cosine_attention (B7a)        csrc/cosine_attention.cu  *_ref
  fused_cosine_attention_packed (B7b) csrc/cosine_attention.cu  *_ref
  fused_cosine_attention_auto         dispatch between B7a and B7b

Numerics of all three TPU kernels: every operand is cast to fp32 whatever
its type, q and k are unit-normed as t * rsqrt(max(sum t^2, 1e-24)), the
logits are fp32 products scaled by exp(min(s, log 100)) after the product,
plus the fp32 bias and the {0, -100} shift mask, the softmax is fp32 and
normalised, and its product with v is fp32; only the output is rounded, to
the input type.  The packed variant (B7b) puts P windows block-diagonally in
one attention with -1e9 off the diagonal; exp(-1e9 - max) is exactly 0 in
fp32, so it is B7a's function, and on the card both launch the same kernel:
3xTF32 products on tensor cores (fp32 accuracy), head dims up to 64.

Dispatch (`kernels=True`, the default): a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version.  `kernels=False` runs the
plain version on any device.  The kernels have no backward, so with
`kernels=True` an input that requires grad under grad mode raises.
"""

from __future__ import annotations

import math

import torch

from grlir_torch.ops import cuda_build
from grlir_torch.ops.block_attn import (
    COUNTED,
    _band_mask,
    _check_inference,
    _ptr,
    _scale,
    _stream,
    _unit,
)
from grlir_torch.utils.profiling import kernel_work, tensor_bytes

# head dims the kernel takes (its tiles hold 32 or 64 columns); keys
# stream through shared memory in chunks, any number of them
MAX_D = 64


def _softmax_v(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 normalised softmax over the last axis, times fp32 v."""
    return torch.softmax(attn, -1) @ v


# ------------------------------------------------------------------ B6

def fused_window_attention_qkv_ref(qkv, logit_scale, bias, num_heads: int,
                                   bands=None) -> torch.Tensor:
    """Plain PyTorch B6 (`_qkv_attention_kernel`), channel-major layout.

    qkv: (B, nW, 3C, N) partitioned windows, channels in [3, heads, d]
    order; logit_scale: (h, 1, 1) raw; bias: (h, N, N); bands: (nW, N) int
    or None.  Returns (B, nW, C, N) in qkv's type."""
    B, nW, C3, N = qkv.shape
    h = num_heads
    q, k, v = qkv.float().reshape(B, nW, 3, h, C3 // (3 * h), N).unbind(2)
    attn = _unit(q, -2).transpose(-1, -2) @ _unit(k, -2)      # (B, nW, h, N, N)
    attn = attn * _scale(logit_scale).reshape(h, 1, 1) + bias.float()
    if bands is not None:
        attn = attn + _band_mask(bands, bands)
    y = _softmax_v(attn, v.transpose(-1, -2))                 # (B, nW, h, N, d)
    return y.transpose(-1, -2).reshape(B, nW, C3 // 3, N).to(qkv.dtype)


def _qkv_work(qkv, logit_scale, bias, bands):
    """B6's work for `profiling.cost_analysis`: the logits' and the weighted
    sum's FLOPs as torch's FlopCounterMode counts the plain version, and
    each operand read once, y written once."""
    B, nW, C3, N = qkv.shape
    return (4 * B * nW * N * N * (C3 // 3),
            tensor_bytes(qkv, logit_scale, bias, bands) + qkv.numel() // 3 * qkv.element_size())


def _cosine_work(q, k, v, logit_scale, bias, mask):
    """B7a's and B7b's work, as `_qkv_work` (B7b's kernel computes B7a's
    function: the plain packed version's off-diagonal blocks are not its
    work)."""
    B, nW, h, N1, d = q.shape
    return (4 * B * nW * h * N1 * k.shape[3] * d,
            tensor_bytes(q, k, v, logit_scale, bias, mask, q))


def fused_window_attention_qkv(qkv, logit_scale, bias, num_heads: int,
                               bands=None, kernels: bool = True) -> torch.Tensor:
    """Window attention from partitioned channel-major qkv (B6): the CUDA
    kernel of `csrc/cosine_attention.cu` for a CUDA qkv, the plain version
    for a CPU qkv or when kernels=False.  Arguments as in
    `fused_window_attention_qkv_ref` (the TPU's `channel_major=True`)."""
    args = (qkv, logit_scale, bias, num_heads, bands)
    if not kernels:
        return fused_window_attention_qkv_ref(*args)
    _check_inference("fused_window_attention_qkv", qkv, logit_scale, bias)
    if not qkv.is_cuda:
        return fused_window_attention_qkv_ref(*args)
    B, nW, C3, N = qkv.shape
    h = num_heads
    C = C3 // 3
    d = C // h
    if C3 % (3 * h) or tuple(bias.shape) != (h, N, N) or (
            bands is not None and tuple(bands.shape) != (nW, N)):
        raise ValueError(f"fused_window_attention_qkv: qkv {tuple(qkv.shape)}, "
                         f"bias {tuple(bias.shape)} with {h} heads")
    _check_limits("fused_window_attention_qkv", d)
    x = _kernel_dtype(qkv).contiguous()
    # every operand the kernel reads stays referenced until it is enqueued
    scale, bias = _scale(logit_scale).contiguous(), _f32(bias, x)
    bands = None if bands is None else _i32(bands, x)
    y = torch.empty((B, nW, C, N), dtype=x.dtype, device=x.device)
    # q, k and v are the three channel blocks of x: element strides
    # (window, head, token, channel) as those of a (B, nW, h, N, d) view
    q, k, v = x.reshape(B, nW, 3, h, d, N).transpose(-1, -2).unbind(2)
    err = cuda_build.library().grlir_window_attention_qkv(
        *_views(q, k, v, y.reshape(B, nW, h, d, N).transpose(-1, -2)),
        _ptr(scale), _ptr(bias), None, _ptr(bands),
        B * nW, nW, h, d, N, N, int(x.dtype == torch.bfloat16), _stream(x))
    cuda_build.check(err, "fused_window_attention_qkv", f"N={N} at d={d}")
    fused_window_attention_qkv.launches += 1
    kernel_work(_qkv_work, x, scale, bias, bands)
    return y


fused_window_attention_qkv.launches = 0


# ------------------------------------------------------------ B7a and B7b

def fused_cosine_attention_ref(q, k, v, logit_scale, bias,
                               mask=None) -> torch.Tensor:
    """Plain PyTorch B7a (`_attention_kernel`).

    q: (B, nW, h, N1, d); k, v: (B, nW, h, N2, d); logit_scale: (h, 1, 1)
    raw; bias: (h, N1, N2); mask: (nW, N1, N2) additive or None.  Returns
    (B, nW, h, N1, d) in q's type."""
    h = q.shape[2]
    attn = _unit(q.float()) @ _unit(k.float()).transpose(-1, -2)
    attn = attn * _scale(logit_scale).reshape(h, 1, 1) + bias.float()
    if mask is not None:
        attn = attn + mask.float()[:, None]
    return _softmax_v(attn, v.float()).to(q.dtype)


def fused_cosine_attention_packed_ref(q, k, v, logit_scale, bias, mask=None,
                                      pack: int = 4) -> torch.Tensor:
    """Plain PyTorch B7b (`_packed_attention_kernel`), packed as the TPU
    packs it: `pack` neighbouring windows share one (P*N1, P*N2) attention,
    -1e9 off the diagonal blocks, the bias tiled P x P, the shift masks on
    the diagonal.  Arguments as in `fused_cosine_attention_ref`."""
    B, nW, h, N1, d = q.shape
    N2 = k.shape[3]
    W = B * nW
    pack = math.gcd(W, pack)
    WP = W // pack

    def packed(t, n):
        return (t.float().reshape(WP, pack, h, n, d).transpose(1, 2)
                .reshape(WP, h, pack * n, d))

    bd = torch.full((pack * N1, pack * N2), -1e9, device=q.device)
    for i in range(pack):
        bd[i * N1:(i + 1) * N1, i * N2:(i + 1) * N2] = 0.0
    attn = _unit(packed(q, N1)) @ _unit(packed(k, N2)).transpose(-1, -2)
    attn = (attn * _scale(logit_scale).reshape(h, 1, 1)
            + bias.float().repeat(1, pack, pack) + bd)
    if mask is not None:
        m = mask.float().expand(B, nW, N1, N2).reshape(WP, pack, N1, N2)
        diag = torch.zeros((WP, pack * N1, pack * N2), device=q.device)
        for i in range(pack):
            diag[:, i * N1:(i + 1) * N1, i * N2:(i + 1) * N2] = m[:, i]
        attn = attn + diag[:, None]
    y = _softmax_v(attn, packed(v, N2))                       # (WP, h, P*N1, d)
    y = y.reshape(WP, h, pack, N1, d).transpose(1, 2)
    return y.reshape(B, nW, h, N1, d).to(q.dtype)


def _launch_cosine(name, entry, q, k, v, logit_scale, bias, mask):
    """Launch the B7 kernel through C entry `entry` on CUDA q, k, v (any
    strides whose batch and window axes merge); y takes q's layout, so a
    d-major view in gives a d-major view out."""
    B, nW, h, N1, d = q.shape
    N2 = k.shape[3]
    if (tuple(k.shape) != (B, nW, h, N2, d) or tuple(v.shape) != tuple(k.shape)
            or tuple(bias.shape) != (h, N1, N2)
            or (mask is not None and tuple(mask.shape) != (nW, N1, N2))):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"bias {tuple(bias.shape)} do not fit")
    _check_limits(name, d)
    q, k, v = (_mergeable(_kernel_dtype(t, q.dtype)) for t in (q, k, v))
    # every operand the kernel reads stays referenced until it is enqueued
    scale, bias = _scale(logit_scale).contiguous(), _f32(bias, q)
    mask = None if mask is None else _f32(mask, q)
    if q.stride(-2) == 1:       # token-minor: write y d-major too
        y = torch.empty((B, nW, h, d, N1), dtype=q.dtype,
                        device=q.device).transpose(-1, -2)
    else:
        y = torch.empty((B, nW, h, N1, d), dtype=q.dtype, device=q.device)
    err = getattr(cuda_build.library(), entry)(
        *_views(q, k, v, y), _ptr(scale), _ptr(bias), _ptr(mask), None,
        B * nW, nW, h, d, N1, N2, int(q.dtype == torch.bfloat16), _stream(q))
    cuda_build.check(err, name, f"N1={N1}, N2={N2} at d={d}")
    return y


def fused_cosine_attention(q, k, v, logit_scale, bias, mask=None,
                           kernels: bool = True) -> torch.Tensor:
    """Cosine attention on split q, k, v (B7a): the CUDA kernel of
    `csrc/cosine_attention.cu` for CUDA tensors, the plain version for CPU
    tensors or when kernels=False.  Arguments as in
    `fused_cosine_attention_ref`."""
    args = (q, k, v, logit_scale, bias, mask)
    if not kernels:
        return fused_cosine_attention_ref(*args)
    _check_inference("fused_cosine_attention", q, k, v, logit_scale, bias)
    if not q.is_cuda:
        return fused_cosine_attention_ref(*args)
    y = _launch_cosine("fused_cosine_attention", "grlir_cosine_attention_split",
                       *args)
    fused_cosine_attention.launches += 1
    kernel_work(_cosine_work, *args)
    return y


fused_cosine_attention.launches = 0


def fused_cosine_attention_packed(q, k, v, logit_scale, bias, mask=None,
                                  pack: int = 4,
                                  kernels: bool = True) -> torch.Tensor:
    """Block-diagonally packed cosine attention (B7b): on the card the B7a
    kernel through its own C entry and counter (packing is a trick for the
    TPU's 128-wide matrix unit and changes no value); the plain packed
    version for CPU tensors or when kernels=False."""
    args = (q, k, v, logit_scale, bias, mask)
    if not kernels:
        return fused_cosine_attention_packed_ref(*args, pack=pack)
    _check_inference("fused_cosine_attention_packed", q, k, v, logit_scale,
                     bias)
    if not q.is_cuda:
        return fused_cosine_attention_packed_ref(*args, pack=pack)
    y = _launch_cosine("fused_cosine_attention_packed",
                       "grlir_cosine_attention_packed", *args)
    fused_cosine_attention_packed.launches += 1
    kernel_work(_cosine_work, *args)
    return y


fused_cosine_attention_packed.launches = 0


def fused_cosine_attention_auto(q, k, v, logit_scale, bias, mask=None,
                                kernels: bool = True) -> torch.Tensor:
    """The TPU's dispatch (`fused_cosine_attention_auto`): square windows of
    at most 128 tokens go packed (B7b) when the window count allows a pack
    of 2 or 4, everything else to B7a."""
    B, nW, _, N1, _ = q.shape
    if N1 == k.shape[3] and N1 <= 128:
        pack = math.gcd(B * nW, 4)
        if pack > 1:
            return fused_cosine_attention_packed(q, k, v, logit_scale, bias,
                                                 mask, pack, kernels)
    return fused_cosine_attention(q, k, v, logit_scale, bias, mask, kernels)


# ---------------------------------------------------------------- helpers

def _check_limits(name: str, d: int) -> None:
    if d > MAX_D:
        raise NotImplementedError(
            f"{name}: head dim {d} > {MAX_D} is beyond the kernel's tiles")


def _kernel_dtype(t: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or t.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inputs must be float32 or bfloat16, got {dtype}")
    return t.to(dtype)


def _mergeable(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy when its batch and window axes do not merge
    into one stride."""
    return t if t.stride(0) == t.shape[1] * t.stride(1) else t.contiguous()


def _views(q, k, v, y):
    """The kernel's operand arguments: the pointers of q, k, v, y, then the
    (window, head, token, channel) element strides of each, all four
    (B, nW, h, N, d) tensors whose batch and window axes merge."""
    ts = (q, k, v, y)
    return (*map(_ptr, ts), *(s for t in ts for s in t.stride()[1:]))


def _f32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        raise ValueError(f"operand on {t.device}, input on {like.device}")
    return t.float().contiguous()


def _i32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        raise ValueError(f"operand on {t.device}, input on {like.device}")
    return t.to(torch.int32).contiguous()


KERNELS = (fused_window_attention_qkv, fused_cosine_attention,
           fused_cosine_attention_packed)
COUNTED.extend(KERNELS)
