"""Autoregressive WaveNet synthesis (counterpart of
nsynth_wavenet_tpu/models/fastgen.py).

``Fastgen.generate`` is the plain step loop, the counterpart of the
reference's lax.scan path: per-layer ring buffers of 2*dilation rows (slot
t mod 2d holds the t-2d state and is overwritten with the t state, slot
(t-d) mod 2d holds the t-d state), every layer's mel conditioning computed
per step by one stacked matmul, samplers drawing from a torch.Generator.

``Fastgen.generate_cuda`` is the serving path: mel -> deconv on the device
-> the whole utterance in the CUDA kernel of ops/fastgen_kernel.py (the
counterpart of generate_pallas, one-shot).
"""

from typing import Optional

import torch

from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import distributions as dist
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import signal as sig


def _mat(p, dtype):
    """Conv params -> ([fl*in, out] matrix in dtype, f32 bias)."""
    w = conv_ops.effective_kernel(p)
    w = w.reshape(w.shape[0] * w.shape[1], w.shape[2])
    return (w if dtype is None else w.to(dtype)), p["b"]


def _mm(x, w, b):
    """x @ w with operands in w's dtype, f32 accumulation, f32 bias."""
    return x.to(w.dtype).float() @ w.float() + b


class Fastgen:
    """AR sampler sharing the teacher's parameter pytree."""

    def __init__(self, model: Wavenet):
        self.model = model
        self.cfg = model.cfg

    @torch.no_grad()
    def generate(self, params, mel, generator: torch.Generator,
                 length: Optional[int] = None, *, teacher_force=None, cond_offset: int = 0,
                 collect_out_params: bool = False):
        """mel [B, T, num_mel] -> audio [B, L] (and out_params [B, L, out_width]).

        teacher_force [B, L]: feed these samples back instead of the model's
        own.  cond_offset: start of the generated window in the upsampled
        conditioning (training centre-trims, so (enc_len - L)//2 reproduces it).
        """
        cfg, dtype = self.cfg, self.model.dtype
        width, gw = cfg.width, cfg.gate_width
        m, half = gw // 2, cfg.quant_chann // 2
        encoding = self.model.deconv_stack(params, mel).float()
        B, enc_len = encoding.shape[:2]
        L = enc_len - cond_offset if length is None else length
        if L + cond_offset > enc_len:
            raise ValueError(f"window {cond_offset}+{L} exceeds conditioning length {enc_len}")
        dev = encoding.device

        start, skip0 = _mat(params["conv_start"], dtype), _mat(params["skip_start"], dtype)
        out1, out2 = _mat(params["out1"], dtype), _mat(params["out2"], dtype)
        layers = []
        for lp in params["layers"]:
            rw, rb = _mat(lp["res"], dtype)
            sw, sb = _mat(lp["skip"], dtype)
            layers.append((_mat(lp["dilated"], dtype), (torch.cat([rw, sw], 1), torch.cat([rb, sb]))))
        conds = [_mat(lp["mel_cond"], dtype) for lp in params["layers"]]
        conds.append(_mat(params["mel_cond_out1"], dtype))
        cond_w = torch.cat([c[0] for c in conds], 1)
        cond_b = torch.cat([c[1] for c in conds])

        dils = [2 ** (i % cfg.num_stages) for i in range(cfg.num_layers)]
        xbuf = torch.zeros((B, 2, 1), device=dev)
        lbufs = [torch.zeros((B, 2 * d, width), device=dev) for d in dils]
        prev = torch.zeros((B,), device=dev)
        audio = torch.empty((B, L), device=dev)
        outs = torch.empty((B, L, cfg.out_width), device=dev) if collect_out_params else None

        def read_write(buf, t, d, new):
            """(state at t-2d, state at t-d); then slot t mod 2d <- new."""
            s2d = buf[:, t % (2 * d)].clone()
            sd = buf[:, (t - d) % (2 * d)].clone()
            buf[:, t % (2 * d)] = new
            return s2d, sd

        for t in range(L):
            if teacher_force is not None:
                prev = teacher_force[:, t - 1].float() if t > 0 else torch.zeros_like(prev)
            x_in = (sig.mu_law(prev) / float(half) if cfg.use_mu_law else prev)[:, None]
            s2d, sd = read_write(xbuf, t, 1, x_in)
            l = _mm(torch.cat([s2d, sd, x_in], 1), *start)
            s = _mm(l, *skip0)
            c_all = _mm(encoding[:, t + cond_offset], cond_w, cond_b)
            for i, (dil_w, rs_w) in enumerate(layers):
                s2d, sd = read_write(lbufs[i], t, dils[i], l)
                d = _mm(torch.cat([s2d, sd, l], 1), *dil_w) + c_all[:, i * gw : (i + 1) * gw]
                d = torch.sigmoid(d[:, :m]) * torch.tanh(d[:, m:])
                rs = _mm(d, *rs_w)
                l = l + rs[:, :width]
                s = s + rs[:, width:]
            s = torch.relu(_mm(torch.relu(s), *out1) + c_all[:, len(layers) * gw :])
            out = _mm(s, *out2)
            if outs is not None:
                outs[:, t] = out
            if cfg.loss_type == "ce":
                q = dist.ce_sample(generator, out, cfg.quant_chann)
            elif cfg.loss_type == "mol":
                q = dist.mol_sample(generator, out, cfg.quant_chann)
            else:
                q = dist.gauss_sample(generator, out, cfg.quant_chann)
            prev = sig.inv_mu_law(q) if cfg.use_mu_law else sig.inv_cast_quantize(q, cfg.quant_chann)
            audio[:, t] = prev
        if collect_out_params:
            return audio, outs
        return audio

    @torch.no_grad()
    def generate_cuda(self, params, mel, seed: int, length: Optional[int] = None, *,
                      cond_offset: int = 0, kw=None):
        """Serving path: deconv on mel's device, then the whole utterance
        through fastgen_kernel.generate (the CUDA kernel on a CUDA device).
        Any batch size runs as it is: the kernel masks the rows past B in its
        tiles.  cond_offset: start of the generated window in the upsampled
        conditioning, as in generate.  kw: packed weights from
        fastgen_kernel.build_kernel_weights, to pack once for many calls.
        Returns audio [B, L] f32."""
        encoding = self.model.deconv_stack(params, mel)
        enc_len = encoding.shape[1]
        L = enc_len - cond_offset if length is None else length
        if L + cond_offset > enc_len:
            raise ValueError(f"window {cond_offset}+{L} exceeds conditioning length {enc_len}")
        enc_t = encoding.transpose(0, 1)[cond_offset : cond_offset + L]
        enc_t = enc_t.to(torch.bfloat16).contiguous()
        if kw is None:
            kw = fk.build_kernel_weights(self.cfg, params)
        return fk.generate(kw, enc_t, seed)
