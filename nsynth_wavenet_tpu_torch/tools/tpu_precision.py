"""The one platform-dependent part of a distillation step, as a reading: the
f32 contractions that a TPU computes at ``jax.lax.Precision.DEFAULT`` in a
single bf16 pass.

In the smoke's bf16 distillation step every convolution already takes bf16
operands on every platform.  The contractions left in f32 are the DFTs of
``stft_center`` (the conditioning mel) and ``stft_pad_end`` (the power loss),
which the JAX package computes as matmuls against cos / sin tables
(nsynth_wavenet_tpu/ops/stft.py ``_rfft``), and the mel filterbank product.
A TPU rounds each f32 operand of these to bf16 and accumulates the exact
products in f32, in the forward pass and in both products of the backward
pass; the CPU and the port compute them in f32.

``tpu_default_precision()`` makes the port do what the TPU does, for the
span of a block: ``stft_ops.stft_center``, ``stft_pad_end`` and
``melspec_from_spec`` are replaced by versions whose products go through
``Bf16Dot``.  It is a reading of the tools, not an option of the program:
nothing else in the port reaches it."""

import contextlib
from functools import lru_cache

import numpy as np
import torch

from nsynth_wavenet_tpu_torch.ops import stft as stft_ops


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and held in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Bf16Dot(torch.autograd.Function):
    """a [..., K] @ b [K, N] with both operands rounded to bf16 and the
    products accumulated in f32: a TPU's f32 dot at Precision.DEFAULT.  The
    backward pass's two products round their operands (the cotangent too)
    the same way.  The products are f32 matmuls of bf16 values, exact
    whether or not the card takes them in TF32 (whose 10-bit mantissa holds
    a bf16 value), so only the f32 sums round."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_bf16(a) @ round_bf16(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = round_bf16(g)
        ga = g16 @ round_bf16(b).T if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = round_bf16(a).reshape(-1, a.shape[-1]).T @ g16.reshape(-1, g.shape[-1])
        return ga, gb


@lru_cache(maxsize=2)
def dft_tables(n_fft: int):
    """The JAX package's DFT tables (ops/stft.py ``_dft_matrices``): cos and
    -sin [n_fft, n_fft // 2 + 1], rounded to f32."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def bf16_rfft(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """rfft of real frames [..., n_fft] as the TPU computes JAX's ``_rfft``:
    two Bf16Dot products against the DFT tables."""
    cos_m, sin_m = (torch.from_numpy(t).to(frames.device, frames.dtype)
                    for t in dft_tables(n_fft))
    return torch.complex(Bf16Dot.apply(frames, cos_m), Bf16Dot.apply(frames, sin_m))


def _stft_center(y, p=stft_ops.MEL_PARAMS):
    n_fft, hop, pad = p.n_fft, p.hop_length, p.n_fft // 2
    y = stft_ops._float(y)
    lead = y.shape[:-1]
    y_padded = torch.nn.functional.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad),
                                       mode="reflect")[:, 0]
    frames = y_padded.reshape(*lead, -1).unfold(-1, n_fft, hop)
    window = torch.from_numpy(stft_ops._centred_window(p)).to(y.device)
    return bf16_rfft(frames * window, n_fft)


def _stft_pad_end(y, p=stft_ops.MEL_PARAMS):
    n_fft, hop, win = p.n_fft, p.hop_length, p.win_length
    y = stft_ops._float(y)
    length = y.shape[-1]
    n_frames = -(-length // hop)
    pad_amt = max(0, (n_frames - 1) * hop + win - length)
    frames = torch.nn.functional.pad(y, (0, pad_amt)).unfold(-1, win, hop)
    window = torch.from_numpy(stft_ops.hann_window(win)).to(y.device)
    return bf16_rfft(torch.nn.functional.pad(frames * window, (0, n_fft - win)), n_fft)


def _melspec_from_spec(spec, p=stft_ops.MEL_PARAMS):
    basis = torch.from_numpy(stft_ops.mel_filterbank(
        p.sample_rate, p.n_fft, p.num_mel, p.mel_fmin, p.mel_fmax).copy()).to(spec.device)
    return Bf16Dot.apply(spec, basis.T.to(spec.dtype).contiguous())


@contextlib.contextmanager
def tpu_default_precision():
    """Inside the block the port's STFTs and mel product take bf16-rounded
    operands with f32 accumulation, forward and backward (module doc)."""
    saved = stft_ops.stft_center, stft_ops.stft_pad_end, stft_ops.melspec_from_spec
    stft_ops.stft_center, stft_ops.stft_pad_end, stft_ops.melspec_from_spec = (
        _stft_center, _stft_pad_end, _melspec_from_spec)
    try:
        yield
    finally:
        stft_ops.stft_center, stft_ops.stft_pad_end, stft_ops.melspec_from_spec = saved
