"""Samplers of the three output heads and the student's base noise
(counterpart of the sampler half of nsynth_wavenet_tpu/ops/distributions.py).
Each head sampler returns int32 quantized samples in
[-quant_chann/2, quant_chann/2).  Randomness comes from an explicit
``torch.Generator``; uniforms lie on the open interval [1e-5, 1 - 1e-5] like
the reference's."""

import torch

from nsynth_wavenet_tpu_torch.ops import signal as sig

U_MIN = 1e-5


def uniform_open(generator: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (1.0 - 2 * U_MIN) + U_MIN).to(device)


def ce_sample(generator, logits: torch.Tensor, quant_chann: int) -> torch.Tensor:
    """Gumbel-max categorical over the last axis."""
    u = uniform_open(generator, logits.shape, logits.device)
    s = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    return s.to(torch.int32) - quant_chann // 2


def mol_sample(generator, mol_params: torch.Tensor, quant_chann: int) -> torch.Tensor:
    """mol_params [..., 3*nr_mix] (logits | means | log scales)."""
    logit_probs, means, scale_params = torch.chunk(mol_params, 3, dim=-1)
    ru = uniform_open(generator, logit_probs.shape, mol_params.device)
    sel = torch.argmax(logit_probs - torch.log(-torch.log(ru)), dim=-1, keepdim=True)
    mean = torch.gather(means, -1, sel)[..., 0]
    scale = torch.exp(torch.clamp(torch.gather(scale_params, -1, sel)[..., 0], -7.0, 7.0))
    ru2 = uniform_open(generator, mean.shape, mol_params.device)
    x = mean + scale * (torch.log(ru2) - torch.log(1.0 - ru2))
    x = torch.clamp(x, -1.0, 1.0 - 2.0 / quant_chann)
    return sig.cast_quantize(x, quant_chann)


def gauss_sample(generator, gauss_params: torch.Tensor, quant_chann: int) -> torch.Tensor:
    """gauss_params [..., 2] (mean, log std)."""
    mean = gauss_params[..., 0]
    std = torch.exp(torch.clamp(gauss_params[..., 1], min=-7.0))
    z = torch.randn(mean.shape, generator=generator, device=generator.device).to(mean.device)
    x = torch.clamp(mean + std * z, -1.0, 1.0 - 2.0 / quant_chann)
    return sig.cast_quantize(x, quant_chann)


def logistic_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the standard logistic at uniforms u in (0, 1)."""
    return torch.log(u) - torch.log(1.0 - u)


def logistic_0_1(generator, shape, device) -> torch.Tensor:
    """Standard logistic(0, 1) noise."""
    return logistic_from_uniform(uniform_open(generator, shape, device))
