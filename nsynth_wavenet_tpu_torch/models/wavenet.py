"""Teacher WaveNet, inference only (counterpart of
nsynth_wavenet_tpu/models/wavenet.py): mel-upsampling deconv stack, gated
dilated-conv stack with residual and skip paths, and the CE / MoL / Gauss
output head.  No dropout and no data-dependent init: those belong to the
training slice.

Parameters are the reference's pytree as nested dicts and lists of
tensors (see weights.py for loading them)."""

import contextlib

import torch

from nsynth_wavenet_tpu_torch.config import WavenetConfig
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops


@contextlib.contextmanager
def no_tf32():
    """Full-f32 convolutions and matmuls inside the block: cuDNN would run an
    f32 model's convolutions in TF32 by default (PyTorch's default for
    convolutions), which parts from the CPU results by more than the parity
    tolerances."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def condition_add(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """x + cond, centre-trimming cond's time axis to x's length."""
    x_len, cond_len = x.shape[1], cond.shape[1]
    if cond_len < x_len:
        raise ValueError(f"conditioning shorter than input ({cond_len} < {x_len})")
    left = (cond_len - x_len) // 2
    return x + cond[:, left : left + x_len]


def apply_deconv_stack(params, mel, *, deconv_config, upsample_act, use_resize_conv,
                       dtype=None, out_dtype=None):
    """mel [B, T, num_mel] -> encoding [B, T * frame_shift, deconv_width]."""
    if use_resize_conv:
        raise NotImplementedError("resize-conv upsampling is not ported yet")
    act = conv_ops.get_upsample_act(upsample_act)
    h = mel
    for i, (_, stride) in enumerate(deconv_config):
        h = conv_ops.trans_conv1d(params[f"up_{i + 1}"], h, stride=stride, dtype=dtype,
                                  out_dtype=out_dtype)
        h = act(h)
    return h


def init_deconv_stack(generator, deconv_config, num_mel, deconv_width, *, device="cuda"):
    """{'up_1', 'up_2', ...} with N(0, 0.05) kernels drawn from ``generator``."""
    params, in_ch = {}, num_mel
    for i, (fl, _) in enumerate(deconv_config):
        params[f"up_{i + 1}"] = conv_ops.conv1d_init(generator, in_ch, deconv_width, fl, device=device)
        in_ch = deconv_width
    return params


class Wavenet:
    """Holds the config; every method is a function of (params, inputs)."""

    def __init__(self, cfg: WavenetConfig):
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None

    def init_params(self, seed: int = 0, *, device="cuda", num_mel=stft_ops.MEL_PARAMS.num_mel):
        """Random parameters in the reference layout, N(0, 0.05) kernels and
        zero biases, drawn from a CPU generator seeded with ``seed``."""
        cfg = self.cfg
        if cfg.use_weight_norm:
            raise NotImplementedError("weight-normed init belongs to the training slice")
        g = torch.Generator().manual_seed(seed)

        def conv(cin, cout, fl=1):
            return conv_ops.conv1d_init(g, cin, cout, fl, device=device)

        deconv = init_deconv_stack(g, cfg.deconv_config, num_mel, cfg.deconv_width, device=device)
        m = cfg.gate_width // 2
        return {
            "deconv": deconv,
            "conv_start": conv(1, cfg.width, cfg.filter_length),
            "skip_start": conv(cfg.width, cfg.skip_width),
            "out1": conv(cfg.skip_width, cfg.skip_width),
            "mel_cond_out1": conv(cfg.deconv_width, cfg.skip_width),
            "out2": conv(cfg.skip_width, cfg.out_width),
            "layers": [
                {
                    "dilated": conv(cfg.width, cfg.gate_width, cfg.filter_length),
                    "mel_cond": conv(cfg.deconv_width, cfg.gate_width),
                    "res": conv(m, cfg.width),
                    "skip": conv(m, cfg.skip_width),
                }
                for _ in range(cfg.num_layers)
            ],
        }

    def encode_signal(self, wav):
        return sig.encode_signal(wav, use_mu_law=self.cfg.use_mu_law,
                                 quant_chann=self.cfg.quant_chann)

    def deconv_stack(self, params, mel):
        cfg = self.cfg
        return apply_deconv_stack(
            params["deconv"], mel, deconv_config=cfg.deconv_config,
            upsample_act=cfg.upsample_act, use_resize_conv=cfg.use_resize_conv,
            dtype=self.dtype, out_dtype=self.dtype,
        )

    @torch.no_grad()
    @no_tf32()
    def feed_forward(self, params, inputs):
        """inputs {'wav_scaled': [B, L], 'mel': [B, T, num_mel]} ->
        {'encoding', 'out_params' [B, L, out_width] f32}."""
        cfg, dtype = self.cfg, self.dtype

        def apply(p, x, dilation=1):
            return conv_ops.conv1d(p, x, dilation=dilation, causal=True, dtype=dtype,
                                   out_dtype=dtype)

        mel_en = self.deconv_stack(params, inputs["mel"])
        l = apply(params["conv_start"], conv_ops.shift_right(inputs["wav_scaled"][..., None]))
        s = apply(params["skip_start"], l)
        m = cfg.gate_width // 2
        for i, lp in enumerate(params["layers"]):
            d = apply(lp["dilated"], l, dilation=2 ** (i % cfg.num_stages))
            d = condition_add(d, apply(lp["mel_cond"], mel_en))
            d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
            l = l + apply(lp["res"], d)
            s = s + apply(lp["skip"], d)
        s = apply(params["out1"], torch.relu(s))
        s = torch.relu(condition_add(s, apply(params["mel_cond_out1"], mel_en)))
        out = apply(params["out2"], s)
        return {"encoding": mel_en, "out_params": out.float()}
