"""Conv primitives over [batch, time, channels] (counterpart of
nsynth_wavenet_tpu/ops/conv.py).

Parameters keep the reference layout: kernels are [filter_length, in, out];
plain layers hold {'w', 'b'}, weight-normed ones {'v', 'g', 'b'}.  The
convolutions go to cuDNN / the CPU library through ``F.conv1d`` and
``F.conv_transpose1d``, as the JAX package leaves them to XLA.

``dtype=torch.bfloat16`` mirrors the reference's mixed precision: operands
rounded to bf16, the product accumulated in f32 and rounded to bf16, then
held as ``out_dtype`` (f32 when None).
"""

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F


def get_upsample_act(act_str: str):
    """Upsampler activation; leaky slope 0.4."""
    if act_str == "tanh":
        return torch.tanh
    if act_str == "relu":
        return torch.relu
    if act_str == "leaky_relu":
        return partial(F.leaky_relu, negative_slope=0.4)
    raise ValueError(f"Unsupported upsample activation: {act_str}")


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """Shift the time axis of [B, T, C] right by one, zero-filling the front."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def conv1d_init(generator, in_ch, out_ch, filter_length, *, device="cuda",
                kernel_stddev=0.05, bias_init=0.0):
    """{'w', 'b'} with w ~ N(0, kernel_stddev) drawn from ``generator``."""
    w = torch.randn((filter_length, in_ch, out_ch), generator=generator) * kernel_stddev
    return {"w": w.to(device), "b": torch.full((out_ch,), bias_init, device=device)}


def effective_kernel(params) -> torch.Tensor:
    """The effective [fl, in, out] kernel, resolving weight norm."""
    if "v" in params:
        v = params["v"]
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1)))
        return v / torch.clamp(norm, min=1e-12)[None, None, :] * params["g"][None, None, :]
    return params["w"]


def _operands(x, w, dtype):
    if dtype is not None:
        x, w = x.to(dtype).float(), w.to(dtype).float()
    return x.float(), w.float()


def _finish(y, b, dtype, out_dtype):
    if dtype is not None:
        y = y.to(dtype).to(out_dtype or torch.float32)
    return y + b.to(y.dtype)


def conv1d(params, x: torch.Tensor, *, dilation: int = 1, causal: bool = True,
           dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None):
    """Length-preserving dilated conv over [B, T, Cin] -> [B, T, Cout].
    causal left-pads (fl-1)*dilation; otherwise SAME padding."""
    w = effective_kernel(params)
    fl = w.shape[0]
    total = (fl - 1) * dilation
    pad = (total, 0) if causal else (total // 2, total - total // 2)
    x, w = _operands(x, w, dtype)
    xt = F.pad(x.transpose(1, 2), pad)
    y = F.conv1d(xt, w.permute(2, 1, 0), dilation=dilation).transpose(1, 2)
    return _finish(y, params["b"], dtype, out_dtype)


def trans_conv1d(params, x: torch.Tensor, *, stride: int,
                 dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None):
    """Transposed conv with SAME semantics: [B, L, Cin] -> [B, stride*L, Cout].

    The reference computes an lhs-dilated cross-correlation with the
    UN-flipped [fl, in, out] kernel and padding (fl-1-p, s-1+p), p = (fl-s)//2.
    That equals ``conv_transpose1d`` with the kernel flipped in time,
    cropped to [p, p + s*L): no zero-stuffing, so no wasted FLOPs."""
    w = effective_kernel(params)
    fl = w.shape[0]
    if fl < stride:
        raise ValueError("upsampling filters must be at least as long as the stride")
    p = (fl - stride) // 2
    length = x.shape[1]
    x, w = _operands(x, w, dtype)
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), stride=stride)
    y = y[..., p : p + stride * length].transpose(1, 2)
    return _finish(y, params["b"], dtype, out_dtype)
