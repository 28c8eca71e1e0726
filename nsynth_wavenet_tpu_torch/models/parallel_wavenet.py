"""Parallel WaveNet student, inference only (counterpart of
nsynth_wavenet_tpu/models/parallel_wavenet.py): a stack of
inverse-autoregressive-flow WaveNets, each with gate_width == width, no skip
path and separate 1x1 mean / scale heads off the residual path.

``feed_forward`` is the plain path, the twin of the reference's XLA path:
every conv goes through ops/conv.py with the model's mixed precision and the
trunk stream is held in the compute dtype.  The serving path with the flow
trunks in the CUDA kernel is models/parallelgen.py.  Losses, data-dependent
init and the teacher pairing belong to the training slice.

Parameters are the reference's pytree:
{'deconv_share'?, 'flows': [{'deconv'?, 'start_conv', 'layers':
[{'dilated', 'mel_cond', 'res'}], 'out1', 'mel_cond_out1', 'out2_mean',
'out2_scale'}]}."""

import math

import torch
import torch.nn.functional as F

from nsynth_wavenet_tpu_torch.config import ParallelWavenetConfig
from nsynth_wavenet_tpu_torch.models import wavenet as wavenet_lib
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import distributions as dist
from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

SCALE_MIN, SCALE_MAX = math.exp(-9.0), math.exp(7.0)


class ParallelWavenet:
    """Holds the config; every method is a function of (params, inputs)."""

    def __init__(self, cfg: ParallelWavenetConfig):
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None

    @property
    def num_flows(self) -> int:
        return len(self.cfg.num_iaf_layers)

    @property
    def shares_deconv(self) -> bool:
        return self.cfg.use_share_deconv or self.cfg.use_teacher_deconv

    @property
    def manual_final_bias(self) -> float:
        return -0.8 if self.cfg.use_log_scale else -0.3

    def init_params(self, seed: int = 0, *, device="cuda", num_mel=stft_ops.MEL_PARAMS.num_mel):
        """Random parameters in the reference layout: N(0, 0.05) kernels, zero
        biases except the manual scale bias of out2_scale, drawn from a CPU
        generator seeded with ``seed``."""
        cfg = self.cfg
        if cfg.use_weight_norm:
            raise NotImplementedError("weight-normed init belongs to the training slice")
        g = torch.Generator().manual_seed(seed)

        def conv(cin, cout, fl=1, bias_init=0.0):
            return conv_ops.conv1d_init(g, cin, cout, fl, device=device, bias_init=bias_init)

        def deconv():
            return wavenet_lib.init_deconv_stack(g, cfg.deconv_config, num_mel, cfg.deconv_width,
                                                 device=device)

        params = {"flows": []}
        if self.shares_deconv:
            params["deconv_share"] = deconv()
        for n_layers in cfg.num_iaf_layers:
            flow = {} if self.shares_deconv else {"deconv": deconv()}
            flow["start_conv"] = conv(1, cfg.width, cfg.filter_length)
            flow["layers"] = [
                {
                    "dilated": conv(cfg.width, cfg.gate_width, cfg.filter_length),
                    "mel_cond": conv(cfg.deconv_width, cfg.gate_width),
                    "res": conv(cfg.gate_width // 2, cfg.width),
                }
                for _ in range(n_layers)
            ]
            flow["out1"] = conv(cfg.width, cfg.width)
            flow["mel_cond_out1"] = conv(cfg.deconv_width, cfg.width)
            flow["out2_mean"] = conv(cfg.width, 1)
            flow["out2_scale"] = conv(
                cfg.width, 1, bias_init=self.manual_final_bias if cfg.manual_final_init else 0.0)
            params["flows"].append(flow)
        return params

    def scale_log_scale(self, scale_params):
        """(scale, log_scale) from the raw output of the scale conv."""
        if self.cfg.use_log_scale:
            log_scale = torch.clamp(scale_params, -9.0, 7.0)
            return torch.exp(log_scale), log_scale
        scale = torch.clamp(F.softplus(scale_params), SCALE_MIN, SCALE_MAX)
        return scale, torch.log(scale)

    def _flow_deconv(self, params, flow_idx: int, mel):
        """The encoding flow ``flow_idx`` is conditioned on, [B, T * frame_shift, DW]."""
        cfg = self.cfg
        dp = params["deconv_share"] if self.shares_deconv else params["flows"][flow_idx]["deconv"]
        return wavenet_lib.apply_deconv_stack(
            dp, mel, deconv_config=cfg.deconv_config,
            upsample_act=cfg.upsample_act, use_resize_conv=cfg.use_resize_conv,
            dtype=self.dtype, out_dtype=self.dtype)

    def _create_iaf(self, flow_params, x, mel_en, flow_idx: int):
        """One IAF flow.  x [B, L, 1] f32 -> dict(x, mean, scale, log_scale)."""
        cfg, dtype = self.cfg, self.dtype

        def apply(p, h, *, dilation=1, head=False):
            # the trunk stream stays in the compute dtype; the mean and scale
            # heads return f32 so the flow composition keeps full precision
            return conv_ops.conv1d(p, h, dilation=dilation, dtype=dtype,
                                   out_dtype=None if head else dtype)

        l = apply(flow_params["start_conv"], conv_ops.shift_right(x))
        m = cfg.gate_width // 2
        for i in range(cfg.num_iaf_layers[flow_idx]):
            lp = flow_params["layers"][i]
            d = apply(lp["dilated"], l, dilation=2 ** (i % cfg.num_stages))
            d = wavenet_lib.condition_add(d, apply(lp["mel_cond"], mel_en))
            d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
            l = l + apply(lp["res"], d)
        l = apply(flow_params["out1"], torch.relu(l))
        l = torch.relu(wavenet_lib.condition_add(l, apply(flow_params["mel_cond_out1"], mel_en)))
        mean = apply(flow_params["out2_mean"], l, head=True)
        scale, log_scale = self.scale_log_scale(apply(flow_params["out2_scale"], l, head=True))
        return {"x": x * scale + mean, "mean": mean, "scale": scale, "log_scale": log_scale}

    def sample_length(self, num_frames: int) -> int:
        cfg = self.cfg
        return (num_frames * cfg.frame_shift // cfg.max_dilation) * cfg.max_dilation

    def base_noise(self, generator: torch.Generator, batch_size: int, length: int, device):
        """Logistic(0, 1) or N(0, 1) base noise [B, L] f32 on ``device``."""
        if self.cfg.loss_type == "logistic":
            return dist.logistic_0_1(generator, (batch_size, length), device)
        return torch.randn((batch_size, length), generator=generator,
                           device=generator.device).to(device)

    def resolve_base_x(self, inputs, generator):
        """The base noise of a forward pass: inputs['base_x'] [B, L] when given,
        else drawn from ``generator``."""
        mel = inputs["mel"]
        B, length = mel.shape[0], self.sample_length(mel.shape[1])
        if "base_x" in inputs:
            x = inputs["base_x"]
            if tuple(x.shape) != (B, length):
                raise ValueError(f"base_x shape {tuple(x.shape)}, want {(B, length)}")
            return x.float()
        if generator is None:
            raise ValueError("feed_forward needs a generator or inputs['base_x']")
        return self.base_noise(generator, B, length, mel.device)

    @torch.no_grad()
    def feed_forward(self, params, inputs, generator=None):
        """inputs {'mel': [B, T, num_mel]} (+ 'base_x' [B, L] to pin the noise)
        -> {'x', 'mean_tot', 'scale_tot', 'log_scale_tot', 'rand_input'}, each
        [B, L] f32."""
        mel = inputs["mel"]
        x = self.resolve_base_x(inputs, generator)
        shared_enc = self._flow_deconv(params, 0, mel) if self.shares_deconv else None
        iaf_x = x[..., None]
        mean_tot, scale_tot, log_scale_tot = 0.0, 1.0, 0.0
        for fi, fp in enumerate(params["flows"]):
            mel_en = shared_enc if shared_enc is not None else self._flow_deconv(params, fi, mel)
            iaf = self._create_iaf(fp, iaf_x, mel_en, fi)
            iaf_x = iaf["x"]
            mean_tot = iaf["mean"] + mean_tot * iaf["scale"]
            scale_tot = scale_tot * iaf["scale"]
            log_scale_tot = log_scale_tot + iaf["log_scale"]
        return compose_output(x, mean_tot[..., 0], scale_tot[..., 0], log_scale_tot[..., 0])

    def _clip_quant_scale(self, x):
        """Clip and requantize the student sample to values seen in data."""
        cfg = self.cfg
        xq = sig.cast_quantize(torch.clamp(x, -1.0, 1.0 - 2.0 / cfg.quant_chann), cfg.quant_chann)
        if cfg.use_mu_law:
            return sig.inv_mu_law(xq)
        return sig.inv_cast_quantize(xq, cfg.quant_chann)


def compose_output(x, mean_tot, scale_tot, log_scale_tot):
    """The ff dict from the base noise and the composed flow statistics; the
    e^7 / 7 clamps apply to the composition only here, at its end."""
    scale_tot = torch.clamp(scale_tot, max=SCALE_MAX)
    return {
        "x": x * scale_tot + mean_tot,
        "mean_tot": mean_tot,
        "scale_tot": scale_tot,
        "log_scale_tot": torch.clamp(log_scale_tot, max=7.0),
        "rand_input": x,
    }
