"""Parallel WaveNet student (counterpart of
nsynth_wavenet_tpu/models/parallel_wavenet.py): a stack of
inverse-autoregressive-flow WaveNets, each with gate_width == width, no skip
path and separate 1x1 mean / scale heads off the residual path, distilled
from a frozen teacher.

``feed_forward`` is the plain inference path, the twin of the reference's
XLA path: every conv goes through ops/conv.py with the model's mixed
precision and the trunk stream is held in the compute dtype.  The serving
path with the flow trunks in the CUDA kernel is models/parallelgen.py.

Training goes through ``feed_forward_train`` (gradients on, the trunk as
stacked-tap matmuls with native bf16 operands on the card, the
data-dependent init pass of weight-normed students) and the distillation
losses: the Monte-Carlo KL against a MoL teacher, the closed-form KL against
a Gauss teacher, the STFT power loss and the contrastive term.  The frozen
teacher's params get no gradient; the gradient does flow through the
student's sample into the teacher's graph.  The losses take their logistic
draws as tensors (``loss_noise`` draws them from a generator), so that a
test can feed both sides the same numbers.

Parameters are the reference's pytree:
{'deconv_share'?, 'flows': [{'deconv'?, 'start_conv', 'layers':
[{'dilated', 'mel_cond', 'res'}], 'out1', 'mel_cond_out1', 'out2_mean',
'out2_scale'}]}."""

import math

import torch
from torch.utils.checkpoint import checkpoint

from nsynth_wavenet_tpu_torch.config import ParallelWavenetConfig
from nsynth_wavenet_tpu_torch.models import wavenet as wavenet_lib
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import distributions as dist
from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

SCALE_MIN, SCALE_MAX = math.exp(-9.0), math.exp(7.0)


class ParallelWavenet:
    """Holds the config; every method is a function of (params, inputs)."""

    def __init__(self, cfg: ParallelWavenetConfig, teacher=None):
        """teacher: the frozen models.wavenet.Wavenet the losses score
        against (None for serving); its head must pair with the student's
        (MoL with logistic, Gauss with Gauss) and its signal encoding and
        upsampler match."""
        self.cfg = cfg
        self.teacher = teacher
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        if teacher is not None:
            t = teacher.cfg
            if (t.loss_type, cfg.loss_type) not in (("mol", "logistic"), ("gauss", "gauss")):
                raise ValueError(f"a {t.loss_type!r} teacher cannot teach a {cfg.loss_type!r} "
                                 "student (mol pairs with logistic, gauss with gauss)")
            for name in ("use_mu_law", "use_resize_conv", "upsample_act"):
                if getattr(t, name) != getattr(cfg, name):
                    raise ValueError(f"teacher and student differ in {name}: "
                                     f"{getattr(t, name)!r} != {getattr(cfg, name)!r}")

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
        biases except the manual scale bias of out2_scale ({'v', 'g', 'b'}
        with g = ||v|| under weight norm), drawn from a CPU generator seeded
        with ``seed``."""
        cfg = self.cfg
        wn = cfg.use_weight_norm
        g = torch.Generator().manual_seed(seed)

        def conv(cin, cout, fl=1, bias_init=0.0):
            return conv_ops.conv1d_init(g, cin, cout, fl, device=device, bias_init=bias_init,
                                        use_weight_norm=wn)

        def deconv():
            return wavenet_lib.init_deconv_stack(g, cfg.deconv_config, num_mel, cfg.deconv_width,
                                                 device=device, use_weight_norm=wn)

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
        scale = torch.clamp(dist.softplus(scale_params), SCALE_MIN, SCALE_MAX)
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
        return mesh_lib.draw(torch.randn, generator, (batch_size, length)).to(device)

    def resolve_base_x(self, inputs, generator):
        """The base noise of a forward pass: inputs['base_x'] [B, L] when given,
        else drawn from ``generator``."""
        mel = inputs["mel"]
        B, length = mel.shape[0], self.sample_length(mel.shape[1])
        if "base_x" in inputs:
            x = inputs["base_x"]
            if tuple(x.shape) != (B, length):
                raise ValueError(f"base_x shape {tuple(x.shape)}, want {(B, length)}")
            return x if x.dtype == torch.float64 else x.float()
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

    # -- training ------------------------------------------------------------

    def feed_forward_train(self, params, inputs, generator=None, *, init=False,
                           model_group=None, seq_group=None, hist_group=None):
        """The forward with gradients: ({'x', 'mean_tot', 'scale_tot',
        'log_scale_tot', 'rand_input'}, new_params); inputs as feed_forward.

        The trunk's and the heads' convolutions are matmuls over the stacked
        taps (conv_ops.conv1d_taps), native bf16 products on the card under
        bf16 compute; the trunk stream stays in the compute dtype, the mean
        and scale heads and the flow composition in f32.  init=True is the
        data-dependent init pass of a weight-normed student, in f32:
        new_params then holds the rescaled g and b, except the two final
        heads under manual_final_init.  model_group: channel tensor
        parallelism of every flow's layers over that group, as the teacher's
        (models/wavenet.py feed_forward_train).  seq_group: inputs['base_x']
        is this rank's chunk of the noise (mesh.seq_chunk of the sample
        length), the mel the whole signal's; every flow's shift, start conv
        and dilated layers exchange halos, and the upsampler runs on the mel
        frames around the chunk, as the teacher's.  cfg.detail_log:
        ff['detail'] holds each flow's mean scale, log scale and mean (this
        rank's) and the upsamplers' histograms, reduced over ``hist_group``
        (the shared stack's unprefixed, each flow's own under iaf_{i}/)."""
        cfg = self.cfg
        if init and not cfg.use_weight_norm:
            raise ValueError("data-dependent init requires weight norm")
        if init and (model_group is not None or seq_group is not None):
            raise ValueError("the data-dependent init pass runs on whole params and sequences")
        mel = inputs["mel"]
        n = mesh_lib.seq_position(seq_group)[1]
        if n > 1:
            x = inputs["base_x"]
            want = mesh_lib.seq_chunk(self.sample_length(mel.shape[1]), seq_group)
            if tuple(x.shape) != (mel.shape[0], want.stop - want.start):
                raise ValueError(f"base_x shape {tuple(x.shape)}, want this rank's chunk "
                                 f"{(mel.shape[0], want.stop - want.start)}")
            x = x if x.dtype == torch.float64 else x.float()
        else:
            x = self.resolve_base_x(inputs, generator)
        dtype = None if init else self.dtype
        native = dtype is not None and mel.is_cuda
        detail = {} if (cfg.detail_log and not init) else None
        length = x.shape[1] * n

        def deconv(dp, prefix=""):
            def upsample(m, window=None):
                return wavenet_lib.deconv_stack_train(
                    dp, m, deconv_config=cfg.deconv_config, upsample_act=cfg.upsample_act,
                    use_resize_conv=cfg.use_resize_conv, init=init, dtype=dtype, native=native,
                    detail=detail, prefix=prefix, window=window, hist_group=hist_group)

            if init:
                return upsample(mel)
            return wavenet_lib.chunk_encoding(upsample, mel, length, cfg.deconv_config, seq_group)

        new_params = dict(params)
        new_params["flows"] = list(params["flows"])
        shared_enc = None
        if self.shares_deconv:
            shared_enc, new_params["deconv_share"] = deconv(params["deconv_share"])
        iaf_x = x[..., None]
        mean_tot, scale_tot, log_scale_tot = 0.0, 1.0, 0.0
        for fi, fp in enumerate(params["flows"]):
            mel_en = shared_enc
            if mel_en is None:
                mel_en, new_dp = deconv(fp["deconv"], f"iaf_{fi}/")
            iaf, new_fp = self._create_iaf_train(fp, iaf_x, mel_en, fi, init, dtype, native,
                                                 model_group, seq_group)
            if shared_enc is None:
                new_fp["deconv"] = new_dp
            new_params["flows"][fi] = new_fp
            iaf_x = iaf["x"]
            mean_tot = iaf["mean"] + mean_tot * iaf["scale"]
            scale_tot = scale_tot * iaf["scale"]
            log_scale_tot = log_scale_tot + iaf["log_scale"]
            if detail is not None:
                detail[f"scale_{fi}"] = iaf["scale"].detach().mean()
                detail[f"log_scale_{fi}"] = iaf["log_scale"].detach().mean()
                detail[f"mean_{fi}"] = iaf["mean"].detach().mean()
        ff = compose_output(x, mean_tot[..., 0], scale_tot[..., 0], log_scale_tot[..., 0])
        if detail is not None:
            ff["detail"] = detail
        return ff, new_params

    def _create_iaf_train(self, flow_params, x, mel_en, flow_idx, init, dtype, native,
                          model_group=None, seq_group=None):
        """One IAF flow with gradients; returns (dict(x, mean, scale,
        log_scale), new flow params).  mel_en: the whole encoding (init) or
        the one over x's samples."""
        cfg = self.cfg
        new_fp = dict(flow_params)
        new_fp["layers"] = list(flow_params["layers"])

        def conv(p, h, dilation=1, head=False, extended=False):
            return conv_ops.conv1d_taps(p, h, dilation=dilation, dtype=dtype,
                                        out_dtype=None if head else dtype, native=native,
                                        seq_group=seq_group, extended=extended)

        def apply(p, h, dilation=1, head=False, use_init=init):
            if use_init:
                return conv_ops.conv1d_ddi(p, h, dilation=dilation)
            return conv(p, h, dilation, head), p

        l, new_fp["start_conv"] = apply(flow_params["start_conv"],
                                        conv_ops.shift_right(x, seq_group))
        # the 1x1 conditioning products are pointwise in time (the init pass
        # takes its moments over the whole encoding, as the reference does)
        mel_tp = None if init else mesh_lib.copy_to_region(mel_en, model_group)
        m = cfg.gate_width // 2
        for i in range(cfg.num_iaf_layers[flow_idx]):
            dilation = 2 ** (i % cfg.num_stages)
            lp = dict(flow_params["layers"][i])
            if init:
                d, lp["dilated"] = apply(lp["dilated"], l, dilation)
                c, lp["mel_cond"] = apply(lp["mel_cond"], mel_en)
                d = wavenet_lib.condition_add(d, c)
                d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
                r, lp["res"] = apply(lp["res"], d)
            else:
                l_in = l
                if seq_group is not None:
                    l_in = conv_ops.extend(l, cfg.filter_length, dilation, seq_group)
                d = (conv(lp["dilated"], mesh_lib.copy_to_region(l_in, model_group), dilation,
                          extended=seq_group is not None)
                     + conv(lp["mel_cond"], mel_tp))
                r = conv_ops.conv1d_taps_row(lp["res"], wavenet_lib._Gate.apply(d), model_group,
                                             dtype=dtype, out_dtype=dtype, native=native)
            l = l + r
            new_fp["layers"][i] = lp

        l, new_fp["out1"] = apply(flow_params["out1"], torch.relu(l))
        c, new_fp["mel_cond_out1"] = apply(flow_params["mel_cond_out1"], mel_en)
        l = torch.relu(wavenet_lib.condition_add(l, c))
        # manual_final_init: the two heads keep their init (the manual scale
        # bias) instead of the data-dependent one
        final_init = init and not cfg.manual_final_init
        mean, new_fp["out2_mean"] = apply(flow_params["out2_mean"], l, head=True,
                                          use_init=final_init)
        scale_params, new_fp["out2_scale"] = apply(flow_params["out2_scale"], l, head=True,
                                                   use_init=final_init)
        scale, log_scale = self.scale_log_scale(scale_params)
        return {"x": x * scale + mean, "mean": mean, "scale": scale,
                "log_scale": log_scale}, new_fp

    @torch.no_grad()
    def data_dep_init(self, params, mel, generator=None, base_x=None):
        """The data-dependent init pass over an init batch's mel: (ff, rescaled params)."""
        inputs = {"mel": mel} if base_x is None else {"mel": mel, "base_x": base_x}
        with wavenet_lib.no_tf32():
            return self.feed_forward_train(params, inputs, generator, init=True)

    # -- losses ---------------------------------------------------------------

    def loss_noise(self, generator, batch_size: int, length: int, device) -> dict:
        """The losses' draws from ``generator``, in the reference's order:
        {'kl': logistic [B, num_samples, L]} and, with the contrastive term,
        {'cl': the same shape}; {} for a Gauss student."""
        cfg = self.cfg
        if cfg.loss_type != "logistic":
            return {}
        shape = (batch_size, cfg.num_samples, length)
        out = {"kl": dist.logistic_0_1(generator, shape, device)}
        if cfg.contrastive_loss_factor > 0.0:
            out["cl"] = dist.logistic_0_1(generator, shape, device)
        return out

    def _clip_or_not(self, x):
        return self._clip_quant_scale(x) if self.cfg.clip else x

    def _teacher_out_params(self, teacher_params, x_scaled, mel, model_group=None,
                            seq_group=None):
        """The frozen teacher's head outputs [B, L, out_width] f32 on the
        student's sample; with remat_teacher its activations are recomputed
        in the backward pass instead of kept (the recompute reads the
        forward's halos: mesh.halo_checkpoint_contexts).  model_group: the
        teacher's params are sharded over it as the student's are;
        seq_group: x_scaled is this rank's chunk (the teacher's trunk
        exchanges its own halos)."""

        def score(xs, m):
            ff, _ = self.teacher.feed_forward_train(teacher_params, {"wav_scaled": xs, "mel": m},
                                                    model_group=model_group, seq_group=seq_group)
            return ff["out_params"]

        if self.cfg.remat_teacher:
            return checkpoint(score, x_scaled, mel, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=mesh_lib.halo_checkpoint_contexts)
        return score(x_scaled, mel)

    def _entropy(self, ff_dict):
        return torch.mean(ff_dict["log_scale_tot"]) + 2.0

    def kl_loss_logistic(self, teacher_params, ff_dict, rl, model_group=None, seq_group=None):
        """Monte-Carlo KL(student || MoL teacher): the teacher scores the
        student's sample x once, and num_samples logistic perturbations
        rl [B, S, L] of it, taken as L(mean_tot, scale_tot), are evaluated
        under its MoL params broadcast over the sample axis."""
        x, mean, scale = ff_dict["x"], ff_dict["mean_tot"], ff_dict["scale_tot"]
        x_xp = rl * scale[:, None, :] + mean[:, None, :]
        te_mol = self._teacher_out_params(teacher_params, self._clip_or_not(x), ff_dict["mel"],
                                          model_group, seq_group)
        log_te = dist.mol_log_probs(te_mol[:, None], self._clip_or_not(x_xp),
                                    self.cfg.quant_chann)  # [B, S, L]
        H_Ps_Pt = torch.mean(-torch.mean(log_te, dim=1))
        H_Ps = self._entropy(ff_dict)
        return {"kl_loss": H_Ps_Pt - H_Ps, "H_Ps": H_Ps, "H_Ps_Pt": H_Ps_Pt}

    def kl_loss_gauss(self, teacher_params, ff_dict, model_group=None, seq_group=None):
        """Closed-form KL(N_q || N_p) a step plus 4 mean((log sigma_p -
        log sigma_q)^2); sigma_p floored at kl_sigma_floor when it is above 0."""
        mean_q, scale_q = ff_dict["mean_tot"], ff_dict["scale_tot"]
        log_scale_q = ff_dict["log_scale_tot"]
        te_out = self._teacher_out_params(teacher_params, self._clip_or_not(ff_dict["x"]),
                                          ff_dict["mel"], model_group, seq_group)
        mean_p, scale_p = dist.mean_std_from_out_params(te_out, use_log_scales=True)
        if self.cfg.kl_sigma_floor > 0.0:
            scale_p = torch.clamp(scale_p, min=self.cfg.kl_sigma_floor)
        log_scale_p = torch.log(scale_p)
        var_q, var_p = scale_q**2.0, scale_p**2.0
        kl = log_scale_p - log_scale_q + (var_q - var_p + (mean_p - mean_q) ** 2.0) / (2.0 * var_p)
        reg = torch.mean((log_scale_p - log_scale_q) ** 2.0)
        return {"kl_loss": torch.mean(kl) + 4.0 * reg}

    @staticmethod
    def _trim_to_match(a, b):
        """Centre-trim the longer of two [B, L] signals to the shorter's length."""
        la, lb = a.shape[1], b.shape[1]
        if la > lb:
            a = a[:, (la - lb) // 2 : (la - lb) // 2 + lb]
        elif lb > la:
            b = b[:, (lb - la) // 2 : (lb - la) // 2 + la]
        return a, b

    def stft_feat(self, stft_complex):
        """The power loss's feature of a complex STFT: |STFT| (through the mel
        filterbank with use_mel), then log (spec_enhance_factor 0), as is
        (1), squared (2) or the four combined along the batch axis (3)."""
        cfg = self.cfg
        y = torch.abs(stft_complex)
        if cfg.use_mel:
            y = stft_ops.melspec_from_spec(y)
        f = cfg.spec_enhance_factor
        if f == 0:
            y = torch.log(torch.clamp(y, min=1e-5))
        elif f == 2:
            y = y**2.0
        elif f == 3:
            rw = (lambda w: w) if cfg.use_l1_loss else math.sqrt
            y = torch.cat([rw(0.4) * y, rw(0.2) * torch.log(torch.clamp(y, min=1e-5)),
                           rw(0.2) * y**1.2, rw(0.2) * y**1.5], dim=0)
        return y

    def power_loss(self, ff_dict, norm_stats=None):
        """Feature distance between the student's sample and the original
        audio; norm_stats: optional per-frequency (mean, std) arrays, applied
        with norm_feat.  The bins below PRIORITY_FREQ count twice unless
        use_mel."""
        cfg = self.cfg
        pred, orig = self._trim_to_match(ff_dict["x"], ff_dict["wav"])
        pred_feat = self.stft_feat(stft_ops.stft_pad_end(pred))
        orig_feat = self.stft_feat(stft_ops.stft_pad_end(orig))
        if cfg.norm_feat and norm_stats is not None:
            mean, std = (torch.as_tensor(v, device=pred_feat.device) for v in norm_stats)
            pred_feat = (pred_feat - mean) / std
            orig_feat = (orig_feat - mean) / std
        diff = orig_feat - pred_feat
        diff = torch.abs(diff) if cfg.use_l1_loss else diff**2.0
        avg = torch.mean(diff)
        if cfg.effective_use_priority_freq:
            avg = 0.5 * avg + 0.5 * torch.mean(diff[:, :, : stft_ops.PRIORITY_FREQ])
        return {"power_loss": avg}

    def contrastive_loss(self, teacher_params, ff_dict, rl, model_group=None, seq_group=None):
        """Minus the KL against the mismatched mel ff_dict['mel_rand']."""
        kl = self.kl_loss_logistic(teacher_params, dict(ff_dict, mel=ff_dict["mel_rand"]), rl,
                                   model_group, seq_group)
        return {"contrastive_loss": -kl["kl_loss"]}

    def kl_and_contrastive_fused(self, teacher_params, ff_dict, rl_kl, rl_cl, model_group=None,
                                 seq_group=None):
        """kl_loss_logistic and contrastive_loss with one teacher pass: the
        two score the same sample under two mels, and the teacher never
        mixes batch rows, so [mel; mel_rand] runs as one 2B batch."""
        x, mean, scale = ff_dict["x"], ff_dict["mean_tot"], ff_dict["scale_tot"]
        B = x.shape[0]
        x_scaled = self._clip_or_not(x)
        te_mol = self._teacher_out_params(
            teacher_params, torch.cat([x_scaled, x_scaled]),
            torch.cat([ff_dict["mel"], ff_dict["mel_rand"]]), model_group,
            seq_group)  # [2B, L, 3 * mix]
        rl = torch.cat([rl_kl, rl_cl])
        x_xp = rl * torch.cat([scale, scale])[:, None, :] + torch.cat([mean, mean])[:, None, :]
        log_te = dist.mol_log_probs(te_mol[:, None], self._clip_or_not(x_xp),
                                    self.cfg.quant_chann)  # [2B, S, L]
        H = -torch.mean(log_te, dim=(1, 2))
        H_Ps_Pt, H_Ps_Pt_rand = torch.mean(H[:B]), torch.mean(H[B:])
        H_Ps = self._entropy(ff_dict)
        return {"kl_loss": H_Ps_Pt - H_Ps, "H_Ps": H_Ps, "H_Ps_Pt": H_Ps_Pt,
                "contrastive_loss": -(H_Ps_Pt_rand - H_Ps)}

    def calculate_loss(self, teacher_params, ff_dict, noise, norm_stats=None, model_group=None,
                       seq_group=None):
        """kl + power_loss_factor * power (+ contrastive_loss_factor *
        contrastive).  ff_dict: the forward's outputs and {'mel', 'wav'}
        (+ 'mel_rand'); noise: ``loss_noise``'s draws; model_group: the
        teacher's params are sharded over it.  seq_group: the forward's
        outputs and the draws are this rank's chunk, the mels and the wav
        whole; the KL and contrastive terms are this chunk's means, and the
        power loss is computed whole on every rank from the student's x
        gathered over the group, its gradient scaled by the group's size so
        that the gradient averaged over the data x seq ranks equals the
        unsharded one."""
        cfg = self.cfg
        clf = cfg.contrastive_loss_factor if cfg.loss_type == "logistic" else 0.0
        if cfg.loss_type == "gauss":
            loss_dict = self.kl_loss_gauss(teacher_params, ff_dict, model_group, seq_group)
        elif clf > 0.0:
            loss_dict = self.kl_and_contrastive_fused(teacher_params, ff_dict, noise["kl"],
                                                      noise["cl"], model_group, seq_group)
        else:
            loss_dict = self.kl_loss_logistic(teacher_params, ff_dict, noise["kl"], model_group,
                                              seq_group)
        loss = loss_dict["kl_loss"]
        if cfg.power_loss_factor > 0.0:
            n = mesh_lib.seq_position(seq_group)[1]
            whole = dict(ff_dict, x=mesh_lib.seq_gather(ff_dict["x"], seq_group))
            loss_dict.update(self.power_loss(whole, norm_stats))
            loss = loss + cfg.power_loss_factor * mesh_lib.scale_grad(loss_dict["power_loss"], n)
        if clf > 0.0:
            loss = loss + clf * loss_dict["contrastive_loss"]
        loss_dict["loss"] = loss
        return loss_dict

    def _clip_quant_scale(self, x):
        """Clip and requantize the student sample to values seen in data."""
        cfg = self.cfg
        xq = sig.cast_quantize(torch.clamp(x, -1.0, 1.0 - 2.0 / cfg.quant_chann), cfg.quant_chann)
        if cfg.use_mu_law:
            return sig.inv_mu_law(xq)
        return sig.inv_cast_quantize(xq, cfg.quant_chann)


def transplant_teacher_deconv(student_params, teacher_params):
    """The student's deconv stack(s) set to copies of the teacher's trained
    deconv weights (the shared stack, or each flow's own)."""
    copy = lambda: tree_lib.tree_map(lambda t: t.detach().clone(), teacher_params["deconv"])  # noqa: E731
    out = dict(student_params)
    if "deconv_share" in student_params:
        out["deconv_share"] = copy()
    else:
        out["flows"] = [dict(f, deconv=copy()) for f in student_params["flows"]]
    return out


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
