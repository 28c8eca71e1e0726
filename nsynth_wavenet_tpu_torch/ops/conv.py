"""Conv primitives over [batch, time, channels] (counterpart of
nsynth_wavenet_tpu/ops/conv.py).

Parameters keep the reference layout: kernels are [filter_length, in, out];
plain layers hold {'w', 'b'}, weight-normed ones {'v', 'g', 'b'}.  The
convolutions go to cuDNN / the CPU library through ``F.conv1d`` and
``F.conv_transpose1d``, as the JAX package leaves them to XLA.

``dtype=torch.bfloat16`` mirrors the reference's mixed precision: operands
rounded to bf16, the product accumulated in f32 and rounded to bf16, then
held as ``out_dtype`` (f32 when None).  By default the product runs in f32 on
the rounded operands; ``native=True`` (the training forward, on the card)
hands cuDNN / cuBLAS the bf16 operands instead, which accumulate in f32 and
round the output once: the same values in another summation order at the
tensor cores' rate.

Channel tensor parallelism (parallel/mesh.py): a column-parallel conv (the
output axis sharded) is ``conv1d_taps`` on ``mesh.copy_to_region`` of its
input, and weight norm's norm over axes (0, 1) is local;
``conv1d_taps_row`` (the input axis sharded) sums each output channel's
squared norm over the model group before the division, sums the partial
products over the group, and adds the bias once, after that sum.

Sequence parallelism (parallel/mesh.py): with a ``seq_group`` the time
axis is this rank's chunk of the sequence, and ``shift_right`` and the
causal convs put the steps before the chunk in front of it (a halo of 1,
or of (fl-1)*dilation, from the left neighbours: ``mesh.halo``), take the
taps over the extended input and keep the chunk's outputs.  With a model
group as well, the halo is taken on the model-replicated input before
``mesh.copy_to_region``.

Weight norm's data-dependent init is a pure pass: the ``*_ddi`` functions
return ``(y, new_params)`` with g and b rescaled so that the layer's output
has mean 0 and standard deviation WN_INIT_SCALE over the init batch.
"""

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

WN_INIT_SCALE = 1.0


def get_upsample_act(act_str: str):
    """Upsampler activation; leaky slope 0.4."""
    if act_str == "tanh":
        return torch.tanh
    if act_str == "relu":
        return torch.relu
    if act_str == "leaky_relu":
        return partial(F.leaky_relu, negative_slope=0.4)
    raise ValueError(f"Unsupported upsample activation: {act_str}")


def shift_right(x: torch.Tensor, seq_group=None) -> torch.Tensor:
    """Shift the time axis of [B, T, C] right by one, zero-filling the front
    (with a seq group: the left neighbour's last step in front)."""
    if seq_group is not None:
        return mesh_lib.halo(x, 1, seq_group)[:, :-1, :]
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _l2_norm(v, dim):
    return torch.sqrt(torch.sum(v * v, dim=dim))


def conv1d_init(generator, in_ch, out_ch, filter_length, *, device="cuda",
                use_weight_norm=False, kernel_stddev=0.05, bias_init=0.0):
    """{'w', 'b'} with w ~ N(0, kernel_stddev) drawn from ``generator``; with
    weight norm {'v', 'g', 'b'}, v that draw and g = ||v|| over axes (0, 1)."""
    w = (torch.randn((filter_length, in_ch, out_ch), generator=generator) * kernel_stddev).to(device)
    b = torch.full((out_ch,), bias_init, device=device)
    if use_weight_norm:
        return {"v": w, "g": _l2_norm(w, (0, 1)), "b": b}
    return {"w": w, "b": b}


def effective_kernel(params, norm_group=None) -> torch.Tensor:
    """The effective [fl, in, out] kernel, resolving weight norm.
    norm_group: the model group of a kernel whose input axis is sharded over
    it; each output channel's squared norm is then summed over the group."""
    if "v" in params:
        v, g = params["v"], params["g"]
        sq = torch.sum(v * v, dim=(0, 1))
        if norm_group is not None:
            sq = mesh_lib.sum_partials(sq, norm_group)
            g = mesh_lib.copy_to_region(g, norm_group)
        norm = torch.sqrt(sq)
        return v / torch.clamp(norm, min=1e-12)[None, None, :] * g[None, None, :]
    return params["w"]


def _operands(x, w, dtype, native=False):
    if dtype is not None:
        if native:
            return x.to(dtype), w.to(dtype)
        x, w = x.to(dtype).float(), w.to(dtype).float()
    # f32, or f64 when either operand is (the parity tests hold losses in f64)
    wide = torch.float64 if torch.float64 in (x.dtype, w.dtype) else torch.float32
    return x.to(wide), w.to(wide)


def _finish(y, b, dtype, out_dtype):
    if dtype is not None:
        y = y.to(dtype).to(out_dtype or torch.float32)
    return y + b.to(y.dtype)


def conv1d(params, x: torch.Tensor, *, dilation: int = 1, causal: bool = True,
           dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None,
           native: bool = False):
    """Length-preserving dilated conv over [B, T, Cin] -> [B, T, Cout].
    causal left-pads (fl-1)*dilation; otherwise SAME padding, the odd pad on
    the right (an even filter of 80 pads (39, 40)), padded explicitly."""
    w = effective_kernel(params)
    fl = w.shape[0]
    total = (fl - 1) * dilation
    pad = (total, 0) if causal else (total // 2, total - total // 2)
    x, w = _operands(x, w, dtype, native)
    xt = F.pad(x.transpose(1, 2), pad)
    y = F.conv1d(xt, w.permute(2, 1, 0), dilation=dilation).transpose(1, 2)
    return _finish(y, params["b"], dtype, out_dtype)


class _StackTaps(torch.autograd.Function):
    """[B, T, C] -> [B, T, fl * C]: tap k is x delayed by (fl - 1 - k) *
    dilation, zeros before the start.  Its backward adds the taps' gradients
    back in place (autograd's own, through a padded copy and fl slices,
    fills and copies fl full-size buffers)."""

    @staticmethod
    def forward(ctx, x, fl, dilation):
        ctx.fl, ctx.dilation = fl, dilation
        B, T, C = x.shape
        out = x.new_empty((B, T, fl * C))
        for k in range(fl):
            s = min((fl - 1 - k) * dilation, T)
            dst = out[:, :, k * C : (k + 1) * C]
            dst[:, :s].zero_()
            dst[:, s:].copy_(x[:, : T - s])
        return out

    @staticmethod
    def backward(ctx, g):
        fl, dilation = ctx.fl, ctx.dilation
        T, C = g.shape[1], g.shape[2] // fl
        dx = g[:, :, (fl - 1) * C :].contiguous()
        for k in range(fl - 1):
            s = (fl - 1 - k) * dilation
            if s < T:
                dx[:, : T - s] += g[:, s:, k * C : (k + 1) * C]
        return dx, None, None


class _ExtendedTaps(torch.autograd.Function):
    """[B, H + T, C] with H = (fl - 1) * dilation steps of halo in front ->
    [B, T, fl * C]: tap k of step t is the extended input's row t + k *
    dilation.  The backward adds the taps' gradients into the extended
    input's, halo rows included."""

    @staticmethod
    def forward(ctx, x, fl, dilation):
        ctx.fl, ctx.dilation = fl, dilation
        B, TH, C = x.shape
        T = TH - (fl - 1) * dilation
        out = x.new_empty((B, T, fl * C))
        for k in range(fl):
            out[:, :, k * C : (k + 1) * C].copy_(x[:, k * dilation : k * dilation + T])
        return out

    @staticmethod
    def backward(ctx, g):
        fl, dilation = ctx.fl, ctx.dilation
        B, T, C = g.shape[0], g.shape[1], g.shape[2] // fl
        dx = g.new_zeros((B, T + (fl - 1) * dilation, C))
        for k in range(fl):
            dx[:, k * dilation : k * dilation + T] += g[:, :, k * C : (k + 1) * C]
        return dx, None, None


def extend(x: torch.Tensor, fl: int, dilation: int, seq_group) -> torch.Tensor:
    """x with the (fl - 1) * dilation steps a causal conv reads before it in
    front (mesh.halo; zeros without a seq group): the ``extended`` input of
    conv1d_taps."""
    return mesh_lib.halo(x, (fl - 1) * dilation, seq_group)


def _taps(x, fl, dilation, seq_group, extended):
    if fl == 1:
        return x
    if extended:
        return _ExtendedTaps.apply(x, fl, dilation)
    if seq_group is not None:
        return _ExtendedTaps.apply(extend(x, fl, dilation, seq_group), fl, dilation)
    return _StackTaps.apply(x, fl, dilation)


def conv1d_taps(params, x: torch.Tensor, *, dilation: int = 1,
                dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None,
                native: bool = False, seq_group=None, extended: bool = False):
    """The causal conv1d as one matmul over [B, T, C]: the taps
    [x(t - (fl-1)d), ..., x(t)] stacked on the channel axis times the kernel
    reshaped to [fl * Cin, Cout].  The same sums as ``conv1d(causal=True)``
    in another order; the activations stay channels-last, and the products
    are plain GEMMs (cuDNN's 1-D convolutions transpose every activation,
    and its weight gradient of a dilated convolution is not a tensor-core
    kernel).  seq_group: x is this rank's chunk, and the steps before it
    come from the left neighbours; extended: x already holds them in front
    (``extend``), and the output is the chunk's."""
    w = effective_kernel(params)
    fl, cin, cout = w.shape
    x, w = _operands(x, w, dtype, native)
    x = _taps(x, fl, dilation, seq_group, extended)
    return _finish(x @ w.reshape(fl * cin, cout), params["b"], dtype, out_dtype)


def conv1d_taps_row(params, x: torch.Tensor, group, *, dilation: int = 1,
                    dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None,
                    native: bool = False):
    """Row-parallel conv1d_taps: x and the kernel's input axis sharded over
    the model ``group``, the bias and gain whole.  The squared norm of each
    output channel and the partial products are summed over the group, and
    the bias is added once, after the sum.  group None: conv1d_taps.  (Its
    callers, the res and skip products, are 1x1: pointwise in time, they
    need no halo on a seq axis.)"""
    w = effective_kernel(params, norm_group=group)
    fl, cin, cout = w.shape
    x, w = _operands(x, w, dtype, native)
    if fl > 1:
        x = _StackTaps.apply(x, fl, dilation)
    y = mesh_lib.reduce_from_region(x @ w.reshape(fl * cin, cout), group)
    return _finish(y, params["b"], dtype, out_dtype)


def _ddi_rescale(params, y, init_scale: float = WN_INIT_SCALE):
    """Data-dependent init of (g, b) from the pre-activation y: s =
    init_scale / sqrt(var(y) + 1e-10), g' = g s, b' = b - mean(y) s, and y
    recomputed in closed form as s (y - b) + b'.  Returns (y', new_params)."""
    if "v" not in params:
        raise ValueError("data-dependent init requires weight norm")
    dims = tuple(range(y.ndim - 1))
    m = y.mean(dim=dims)
    var = y.var(dim=dims, unbiased=False)
    scale = init_scale / torch.sqrt(var + 1e-10)
    new_b = params["b"] - m * scale
    new_params = {"v": params["v"], "g": params["g"] * scale, "b": new_b}
    return scale * (y - params["b"]) + new_b, new_params


def conv1d_ddi(params, x, *, dilation: int = 1, causal: bool = True):
    """conv1d + data-dependent init; returns (y, new_params)."""
    return _ddi_rescale(params, conv1d(params, x, dilation=dilation, causal=causal))


def trans_conv1d_ddi(params, x, *, stride: int):
    """trans_conv1d + data-dependent init (pre-activation moments)."""
    return _ddi_rescale(params, trans_conv1d(params, x, stride=stride))


def trans_conv1d(params, x: torch.Tensor, *, stride: int,
                 dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None,
                 native: bool = False):
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
    x, w = _operands(x, w, dtype, native)
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), stride=stride)
    y = y[..., p : p + stride * length].transpose(1, 2)
    return _finish(y, params["b"], dtype, out_dtype)


def resize_conv1d(params, x: torch.Tensor, *, stride: int,
                  dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None,
                  native: bool = False):
    """Nearest-neighbour x``stride`` upsampling followed by a SAME conv:
    [B, L, Cin] -> [B, stride*L, Cout].  Each input frame is repeated
    ``stride`` times along time, then ``conv1d(causal=False)`` pads
    (fl-1)//2 on the left and the rest on the right, as the reference's."""
    return conv1d(params, torch.repeat_interleave(x, stride, dim=1), causal=False, dtype=dtype,
                  out_dtype=out_dtype, native=native)


def resize_conv1d_ddi(params, x, *, stride: int):
    """resize_conv1d + data-dependent init (pre-activation moments)."""
    return _ddi_rescale(params, resize_conv1d(params, x, stride=stride))
