"""Cosine attention for large windows and stripes on channel-major q, k, v.

Torch counterpart of `flash_rect_attention` (B5,
grlir/ops/pallas/flash_attention.py:83), a hand-written CUDA kernel
(`csrc/flash_attention.cu`) with the plain PyTorch version
`flash_rect_attention_ref` beside it.

Numerics of the TPU kernel (`_flash_kernel`): q and k are unit-normed in
fp32 as t * rsqrt(max(sum t^2, 1e-24)) over the head dim and rounded to the
input type; their product is summed in fp32 and scaled by
exp(min(s, log 100)) after it; the bias is read in bf16 under bf16 inputs
and in fp32 otherwise; the {0, -100} shift mask comes from band ids; the
softmax is fp32 and normalised before its probabilities are rounded to the
input type; their product with v is summed in fp32 and rounded to the
input type.  These are the rounding points of B4 (`block_attn`), whose
attention kernel this one shares on the card.  That kernel's one pass
rounds exp(s - max) before it normalises, and scales the product with v
by 1/sum (`csrc/mma_attend.cuh`).

Dispatch (`kernels=True`, the default): a CUDA tensor launches the kernel or
raises, on the route its type picks before any launch (bf16 on tensor
cores, fp32 on CUDA cores; `flash_rect_attention.route_launches` counts
them, and `flash_rect_attention.attend_rows` the tensor-core route's by
query rows a block); a CPU tensor runs the plain version.  `kernels=False`
runs the plain version on any device.
"""

from __future__ import annotations

import torch

from grlir_torch.ops import cuda_build
from grlir_torch.ops.block_attn import (
    COUNTED,
    MAX_D,
    _band_mask,
    _check_inference,
    _count_attend,
    _count_route,
    _head_cols,
    _ptr,
    _scale,
    _stream,
    _unit,
)
from grlir_torch.utils.profiling import kernel_work, tensor_bytes


def _bias_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def flash_rect_attention_ref(q, k, v, logit_scale, bias, bands_q=None,
                             bands_k=None) -> torch.Tensor:
    """Plain PyTorch B5.

    q: (B, nW, h, d, N1); k, v: (B, nW, h, d, N2), channel-major;
    logit_scale: (h, 1, 1) raw; bias: (h, N1, N2) (any float type);
    bands_q/bands_k: (nW, N1)/(nW, N2) int, both or neither.  Returns
    (B, nW, h, d, N1) in q's type."""
    mm = q.dtype
    h = q.shape[2]
    qn = _unit(q.float(), -2).to(mm).float()
    kn = _unit(k.float(), -2).to(mm).float()
    attn = qn.transpose(-1, -2) @ kn                          # (B, nW, h, N1, N2)
    attn = (attn * _scale(logit_scale).reshape(h, 1, 1)
            + bias.to(_bias_dtype(q)).float())
    if bands_q is not None:
        attn = attn + _band_mask(bands_q, bands_k)
    p = torch.softmax(attn, -1).to(mm).float()
    return (v.to(mm).float() @ p.transpose(-1, -2)).to(mm)


def _flash_work(q, k, v, logit_scale, bias, bands_q=None, bands_k=None):
    """B5's work for `profiling.cost_analysis`: the logits' and the weighted
    sum's FLOPs as torch's FlopCounterMode counts the plain version, and
    each operand read once, y written once."""
    B, nW, h, d, N1 = q.shape
    return (4 * B * nW * h * N1 * k.shape[4] * d,
            tensor_bytes(q, k, v, logit_scale, bias, bands_q, bands_k, q))


def flash_rect_attention(q, k, v, logit_scale, bias, bands_q=None,
                         bands_k=None, kernels: bool = True) -> torch.Tensor:
    """B5: the CUDA kernels of `csrc/flash_attention.cu` for CUDA tensors
    (tensor cores for bf16, CUDA cores for fp32), `flash_rect_attention_ref`
    for CPU tensors or when kernels=False.  Arguments as in
    `flash_rect_attention_ref`."""
    if (bands_q is None) != (bands_k is None):
        raise ValueError("flash_rect_attention: pass both bands_q and "
                         "bands_k, or neither")
    args = (q, k, v, logit_scale, bias, bands_q, bands_k)
    if not kernels:
        return flash_rect_attention_ref(*args)
    _check_inference("flash_rect_attention", q, k, v, logit_scale, bias)
    if not q.is_cuda:
        return flash_rect_attention_ref(*args)
    B, nW, h, d, N1 = q.shape
    N2 = k.shape[4]
    if (tuple(k.shape) != (B, nW, h, d, N2) or tuple(v.shape) != tuple(k.shape)
            or tuple(bias.shape) != (h, N1, N2)
            or (bands_q is not None and (tuple(bands_q.shape) != (nW, N1)
                                         or tuple(bands_k.shape) != (nW, N2)))):
        raise ValueError(f"flash_rect_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, bias {tuple(bias.shape)} do not fit")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d > MAX_D:
        raise NotImplementedError(
            f"flash_rect_attention: head dim {d} > {MAX_D} is beyond the "
            "kernel's tiles")
    for t in (k, v, bias, bands_q, bands_k):
        if t is not None and t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    q, k, v = (t.to(q.dtype).contiguous() for t in (q, k, v))
    bands = [None if t is None else t.to(torch.int32).contiguous()
             for t in (bands_q, bands_k)]
    # every operand the kernel reads stays referenced until it is enqueued
    scale = _scale(logit_scale).contiguous()
    bias = bias.to(_bias_dtype(q)).contiguous()
    # q, k unit-normed and v, token-major: the attention kernel's operands,
    # in rows of 32 or 64 columns (zeros past d) for the tensor cores
    ld = _head_cols(d) if q.dtype == torch.bfloat16 else d
    ws_q = torch.empty((B * nW * h, N1, ld), dtype=q.dtype, device=q.device)
    ws_kv = torch.empty((2, B * nW * h, N2, ld), dtype=q.dtype, device=q.device)
    y = torch.empty_like(q)
    err = cuda_build.library().grlir_flash_rect_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(scale), _ptr(bias), _ptr(bands[0]),
        _ptr(bands[1]), _ptr(ws_q), _ptr(ws_kv), _ptr(y), B * nW, nW, h, d, N1,
        N2, int(q.dtype == torch.bfloat16), _stream(q))
    cuda_build.check(err, "flash_rect_attention", f"N1={N1}, N2={N2} at d={d}")
    _count_route(flash_rect_attention, q)
    _count_attend(flash_rect_attention, q, N1, B * nW, h, d)
    kernel_work(_flash_work, *args)
    return y


flash_rect_attention.launches = 0
flash_rect_attention.route_launches = {"tensor_core": 0, "cuda_core": 0}
flash_rect_attention.attend_rows = {64: 0, 128: 0}

# each with a tensor-core and a CUDA-core route, as `block_attn.ROUTED`
KERNELS = (flash_rect_attention,)
COUNTED.extend(KERNELS)
