"""Signal encodings: mu-law companding and linear quantization, with the
reference's floor and offset conventions (counterpart of
nsynth_wavenet_tpu/ops/signal.py)."""

import math

import torch


def mu_law(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """Real signal in [-1, 1) -> integer-valued float in [-128, 128)."""
    out = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return torch.floor(out * 128.0)


def inv_mu_law(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """Integer-valued samples -> real signal; +0.5 bin centre, 0 -> 0."""
    x = x.to(torch.float32)
    out = (x + 0.5) * 2.0 / (mu + 1)
    # the power is rounded once from f64, as the reference's is
    expanded = torch.pow(float(1 + mu), torch.abs(out).double()).float()
    out = torch.sign(out) / mu * (expanded - 1)
    return torch.where(x == 0, x, out)


def cast_quantize(x: torch.Tensor, quant_chann: int) -> torch.Tensor:
    """Real signal in [-1, 1) -> int32 in [-quant_chann/2, quant_chann/2)."""
    return torch.floor(x * (quant_chann / 2)).to(torch.int32)


def inv_cast_quantize(x_quantized: torch.Tensor, quant_chann: int) -> torch.Tensor:
    return x_quantized.to(torch.float32) / (quant_chann / 2)


def encode_signal(wav: torch.Tensor, *, use_mu_law: bool, quant_chann: int):
    """Scaled network input plus real / categorical targets."""
    half = quant_chann // 2
    if use_mu_law:
        x_quantized = mu_law(wav)
        x_scaled = x_quantized / float(half)
        real_targets = x_scaled
        cate_targets = x_quantized.to(torch.int32) + half
    else:
        x_quantized = cast_quantize(wav, quant_chann)
        x_scaled = wav
        real_targets = wav
        cate_targets = x_quantized + half
    cate_targets = torch.clamp(cate_targets, 0, quant_chann - 1)
    return {
        "wav_scaled": x_scaled,
        "real_targets": real_targets,
        "cate_targets": cate_targets,
    }
