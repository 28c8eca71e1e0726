"""Log-probs, losses and samplers of the three output heads, the
mixture-of-Gaussians log-prob, loss and sampler, and the student's base
noise (counterpart of nsynth_wavenet_tpu/ops/distributions.py).
Each head sampler returns int32 quantized samples in
[-quant_chann/2, quant_chann/2).  Randomness comes from an explicit
``torch.Generator`` (or a parallel/mesh.py RowDraws, this rank's rows of
the global batch's draws); uniforms lie on the open interval [1e-5, 1 - 1e-5] like
the reference's.

softplus is ``logaddexp(x, 0)``, as JAX writes it: ``F.softplus`` turns
linear above 20, which would part the two where a gradient meets it."""

import math

import torch

from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

U_MIN = 1e-5


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mol_log_probs(mol_params, targets, quant_chann, use_log_scales=True):
    """Log-likelihood of a mixture of discretized logistics.

    mol_params [..., 3 * nr_mix] (logit_probs | means | scale_params),
    targets [...] rescaled to [-1, 1); returns log-probs shaped as targets."""
    logit_probs, means, scale_params = torch.chunk(mol_params, 3, dim=-1)
    if use_log_scales:
        inv_stdv = torch.exp(-torch.clamp(scale_params, min=-7.0))
    else:
        inv_stdv = 1.0 / torch.clamp(softplus(scale_params), min=math.exp(-7.0))
    t = targets[..., None]
    centered = t - means
    plus_in = inv_stdv * (centered + 1.0 / quant_chann)
    min_in = inv_stdv * (centered - 1.0 / quant_chann)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - softplus(plus_in)  # log sigmoid(plus_in)
    log_one_minus_cdf_min = -softplus(min_in)
    # edge bins: below the lowest / above the highest level the discretized
    # logistic takes the whole tail
    max_thres = (quant_chann - 1.5) / (quant_chann / 2.0) - 1.0
    min_thres = 0.5 / (quant_chann / 2.0) - 1.0
    log_probs = torch.where(
        t < min_thres, log_cdf_plus,
        torch.where(t > max_thres, log_one_minus_cdf_min,
                    torch.log(torch.clamp(cdf_delta, min=1e-12))))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


def mean_std_from_out_params(gauss_params, use_log_scales=True):
    """Split [..., 2] Gaussian head params into (mean, std), both [...]."""
    mean, std_param = gauss_params[..., 0], gauss_params[..., 1]
    if use_log_scales:
        return mean, torch.exp(torch.clamp(std_param, min=-7.0))
    return mean, torch.clamp(softplus(std_param), min=math.exp(-7.0))


def gauss_log_prob(gauss_params, targets, use_log_scales=True):
    mean, std = mean_std_from_out_params(gauss_params, use_log_scales)
    var = std**2.0
    return -0.5 * torch.log(2.0 * math.pi * var) - (targets - mean) ** 2.0 / (2.0 * var)


def mog_log_prob(mog_params, targets, use_log_scales=True):
    """Log-likelihood of a mixture of Gaussians: mog_params [..., 3 * nr_mix]
    (logit_probs | means | std_params), targets [...]; returns [...]."""
    logit_probs, means, std_params = torch.chunk(mog_params, 3, dim=-1)
    if use_log_scales:
        stds = torch.exp(torch.clamp(std_params, min=-7.0))
    else:
        stds = torch.clamp(softplus(std_params), min=math.exp(-7.0))
    var = stds**2.0
    comp_lp = -0.5 * torch.log(2.0 * math.pi * var) - (targets[..., None] - means) ** 2.0 / (2.0 * var)
    return torch.logsumexp(comp_lp + torch.log_softmax(logit_probs, dim=-1), dim=-1)


def ce_loss(logits, cate_targets):
    """Mean sparse softmax cross entropy; targets int in [0, quant_chann)."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.gather(log_probs, -1, cate_targets[..., None].long())[..., 0].mean()


def mol_loss(mol_params, real_targets, quant_chann):
    return -mol_log_probs(mol_params, real_targets, quant_chann).mean()


def gauss_loss(gauss_params, real_targets):
    return -gauss_log_prob(gauss_params, real_targets).mean()


def mog_loss(mog_params, real_targets):
    return -mog_log_prob(mog_params, real_targets).mean()


def uniform_open(generator: torch.Generator, shape, device) -> torch.Tensor:
    u = mesh_lib.draw(torch.rand, generator, shape)
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
    z = mesh_lib.draw(torch.randn, generator, mean.shape).to(mean.device)
    x = torch.clamp(mean + std * z, -1.0, 1.0 - 2.0 / quant_chann)
    return sig.cast_quantize(x, quant_chann)


def mog_sample(generator, mog_params: torch.Tensor, quant_chann: int,
               use_log_scales=True) -> torch.Tensor:
    """mog_params [..., 3*nr_mix] (logits | means | std params): a Gumbel-max
    pick of the component, then its Gaussian; the draws (the pick's uniforms,
    then the normals) come from ``generator``."""
    nr_mix = mog_params.shape[-1] // 3
    ru = uniform_open(generator, mog_params.shape[:-1] + (nr_mix,), mog_params.device)
    z = mesh_lib.draw(torch.randn, generator, mog_params.shape[:-1]).to(mog_params.device)
    return mog_sample_from(mog_params, ru, z, quant_chann, use_log_scales)


def mog_sample_from(mog_params, ru, z, quant_chann: int, use_log_scales=True):
    """mog_sample on given draws: uniforms ru [..., nr_mix] for the pick,
    standard normals z [...] for the value."""
    logit_probs, means, std_params = torch.chunk(mog_params, 3, dim=-1)
    sel = torch.argmax(logit_probs - torch.log(-torch.log(ru)), dim=-1, keepdim=True)
    mean = torch.gather(means, -1, sel)[..., 0]
    std_p = torch.gather(std_params, -1, sel)[..., 0]
    if use_log_scales:
        std = torch.exp(torch.clamp(std_p, -7.0, 7.0))
    else:
        std = torch.clamp(softplus(std_p), min=math.exp(-7.0))
    x = torch.clamp(mean + std * z, -1.0, 1.0 - 2.0 / quant_chann)
    return sig.cast_quantize(x, quant_chann)


def logistic_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the standard logistic at uniforms u in (0, 1)."""
    return torch.log(u) - torch.log(1.0 - u)


def logistic_0_1(generator, shape, device) -> torch.Tensor:
    """Standard logistic(0, 1) noise."""
    return logistic_from_uniform(uniform_open(generator, shape, device))
