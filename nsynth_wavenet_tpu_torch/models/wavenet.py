"""Teacher WaveNet (counterpart of nsynth_wavenet_tpu/models/wavenet.py):
mel-upsampling deconv stack, gated dilated-conv stack with residual and skip
paths, and the CE / MoL / Gauss output head.

``feed_forward`` is the inference forward (no gradients).  Training goes
through ``feed_forward_train``: gradients on, dropout at the reference's
points, optional rematerialization of each layer, the data-dependent init
pass of weight-normed models, channel tensor parallelism and sequence
parallelism (a rank's chunk of the time axis, its upsampler run on a window
of mel frames: ``EncodingWindow``), and the DETAIL_LOG histograms.

Parameters are the reference's pytree as nested dicts and lists of
tensors (see weights.py for loading them)."""

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from nsynth_wavenet_tpu_torch.config import WavenetConfig
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import distributions as dist
from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.utils import logging_utils


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


def _dropout(generator, x, rate):
    """Inverted dropout: keep each value with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate); the mask comes from ``generator`` (a
    mesh_lib.RowDraws: this rank's rows of the global batch's mask)."""
    keep = 1.0 - rate
    mask = mesh_lib.uniform(generator, x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _Gate(torch.autograd.Function):
    """sigmoid(d[..., :m]) * tanh(d[..., m:]) for d [B, T, 2m].  The same
    values and gradient as autograd's, which would fill and copy two
    d-sized buffers for the halves' gradients: here one concatenation."""

    @staticmethod
    def forward(ctx, d):
        m = d.shape[-1] // 2
        a, b = torch.sigmoid(d[..., :m]), torch.tanh(d[..., m:])
        ctx.save_for_backward(a, b)
        return a * b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return torch.cat([torch.ops.aten.sigmoid_backward(g * b, a),
                          torch.ops.aten.tanh_backward(g * a, b)], dim=-1)


def apply_deconv_stack(params, mel, *, deconv_config, upsample_act, use_resize_conv,
                       dtype=None, out_dtype=None):
    """mel [B, T, num_mel] -> encoding [B, T * frame_shift, deconv_width]:
    transposed convolutions, or with use_resize_conv nearest-neighbour
    repeats each followed by a SAME convolution."""
    act = conv_ops.get_upsample_act(upsample_act)
    up = conv_ops.resize_conv1d if use_resize_conv else conv_ops.trans_conv1d
    h = mel
    for i, (_, stride) in enumerate(deconv_config):
        h = act(up(params[f"up_{i + 1}"], h, stride=stride, dtype=dtype, out_dtype=out_dtype))
    return h


def deconv_halo_frames(deconv_config) -> int:
    """Mel frames on each side that bound the upsampling stack's reach: a
    layer of filter fl and stride s reads about fl / s + 1 of its input
    frames each way."""
    reach, unit = 0.0, 1
    for fl, stride in deconv_config:
        reach += (fl / stride + 1) / unit
        unit *= stride
    return int(reach) + 2


class EncodingWindow:
    """Where this rank's chunk of a length-L signal lies in the encoding of
    T mel frames (T * frame_shift samples, the signal at the centring
    offset (T * frame_shift - L) // 2), and the mel frames [fa, fb) whose
    upsampling gives it: the samples the rank owns with
    deconv_halo_frames(deconv_config) frames on each side, so that the
    window's upsampling equals the whole encoding's there.  Rank r of n owns
    the encoding between the global boundaries r L/n + offset (0 for the
    first rank, T * frame_shift after the last): together the ranks own the
    whole encoding once (the histograms count it so).  One rank: the whole
    mel."""

    def __init__(self, T, L, deconv_config, seq_group=None):
        r, n = mesh_lib.seq_position(seq_group)
        self.strides = [s for _, s in deconv_config]
        fs = int(np.prod(self.strides))
        left = (T * fs - L) // 2
        if left < 0:
            raise ValueError(f"conditioning shorter than input ({T * fs} < {L})")
        c = mesh_lib.seq_chunk(L, seq_group)
        self.fs = fs
        self.bounds = (0 if r == 0 else c.start + left, T * fs if r == n - 1 else c.stop + left)
        if n == 1:
            self.fa, self.fb = 0, T
        else:
            hf = deconv_halo_frames(deconv_config)
            self.fa = max(0, self.bounds[0] // fs - hf)
            self.fb = min(T, -(-self.bounds[1] // fs) + hf)
        self.chunk = slice(c.start + left - self.fa * fs, c.stop + left - self.fa * fs)

    def owned(self, layer: int) -> slice:
        """The part of the window's layer-``layer`` output this rank owns."""
        unit = int(np.prod(self.strides[: layer + 1]))
        f = self.fs // unit
        lo, hi = (b // f - self.fa * unit for b in self.bounds)
        return slice(lo, hi)


def deconv_stack_train(params, mel, *, deconv_config, upsample_act, use_resize_conv, init,
                        dtype, native, detail=None, prefix="", window=None, hist_group=None):
    """apply_deconv_stack with gradients; init=True rescales weight-normed
    layers from their pre-activation moments.  Returns (encoding, new_params).
    detail: a dict that gets each layer's histogram (DETAIL_LOG) as
    'hist/{prefix}mel_en_{i}', over the part of ``window`` (an
    EncodingWindow that ``mel`` is the frames of) this rank owns, reduced
    over ``hist_group``."""
    act = conv_ops.get_upsample_act(upsample_act)
    if use_resize_conv:
        up, up_ddi = conv_ops.resize_conv1d, conv_ops.resize_conv1d_ddi
    else:
        up, up_ddi = conv_ops.trans_conv1d, conv_ops.trans_conv1d_ddi
    new_params, h = dict(params), mel
    for i, (_, stride) in enumerate(deconv_config):
        name = f"up_{i + 1}"
        if init:
            h, new_params[name] = up_ddi(params[name], h, stride=stride)
        else:
            h = up(params[name], h, stride=stride, dtype=dtype, out_dtype=dtype, native=native)
        h = act(h)
        if detail is not None:
            own = h if window is None else h[:, window.owned(i)]
            detail[f"hist/{prefix}mel_en_{i}"] = logging_utils.device_histogram(own,
                                                                                groups=hist_group)
    return h, new_params


def chunk_encoding(upsample, mel, length, deconv_config, seq_group=None):
    """(this rank's chunk of the encoding [B, chunk, DW], new params): the
    encoding of a length-``length`` signal that ``upsample(mel_frames,
    window) -> (encoding, new_params)`` gives for the window's mel frames,
    cut to the samples of mesh.seq_chunk(length, seq_group) at the centring
    offset (the whole signal's without a seq group)."""
    window = EncodingWindow(mel.shape[1], length, deconv_config, seq_group)
    enc, new_params = upsample(mel[:, window.fa : window.fb], window)
    return enc[:, window.chunk].contiguous(), new_params


def init_deconv_stack(generator, deconv_config, num_mel, deconv_width, *, device="cuda",
                      use_weight_norm=False):
    """{'up_1', 'up_2', ...} with N(0, 0.05) kernels drawn from ``generator``."""
    params, in_ch = {}, num_mel
    for i, (fl, _) in enumerate(deconv_config):
        params[f"up_{i + 1}"] = conv_ops.conv1d_init(generator, in_ch, deconv_width, fl,
                                                     device=device, use_weight_norm=use_weight_norm)
        in_ch = deconv_width
    return params


class Wavenet:
    """Holds the config; every method is a function of (params, inputs)."""

    def __init__(self, cfg: WavenetConfig):
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None

    def init_params(self, seed: int = 0, *, device="cuda", num_mel=stft_ops.MEL_PARAMS.num_mel):
        """Random parameters in the reference layout, N(0, 0.05) kernels and
        zero biases ({'v', 'g', 'b'} with g = ||v|| under weight norm), drawn
        from a CPU generator seeded with ``seed``."""
        cfg = self.cfg
        wn = cfg.use_weight_norm
        g = torch.Generator().manual_seed(seed)

        def conv(cin, cout, fl=1):
            return conv_ops.conv1d_init(g, cin, cout, fl, device=device, use_weight_norm=wn)

        deconv = init_deconv_stack(g, cfg.deconv_config, num_mel, cfg.deconv_width, device=device,
                                   use_weight_norm=wn)
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

    # -- training ------------------------------------------------------------

    def feed_forward_train(self, params, inputs, *, generator=None, init=False,
                           model_group=None, seq_group=None, hist_group=None):
        """The forward with gradients.  inputs {'wav_scaled': [B, L], 'mel':
        [B, T, num_mel]} -> ({'encoding', 'out_params' f32}, new_params).

        Dropout (dropout_inputs: rate 0.5 on l and s after skip_start;
        dropout_all: rate 0.05 after conv_start and after each layer's
        residual) runs when a ``generator`` is given and the model is not a
        frozen teacher.  cfg.remat recomputes each layer's gate and products
        in the backward pass (torch.utils.checkpoint).  init=True is the
        data-dependent init pass of a weight-normed model, in f32: new_params
        then holds the rescaled g and b.  The trunk's and the head's
        convolutions are matmuls over the stacked taps (conv_ops.conv1d_taps),
        the deconv stack's cuDNN's.  bf16 compute keeps the f32 master params;
        on a CUDA device its products take bf16 operands.  'encoding' is the
        upsampler's output over the input's samples (the centre of the whole
        encoding).

        model_group: channel tensor parallelism over that group (params
        sharded by parallel/mesh.py shard_params): each layer's dilated and
        mel_cond products are column-parallel and give this rank's matched
        sigmoid and tanh halves of the gate, its res and skip products
        row-parallel; every other tensor is whole on every rank.

        seq_group: sequence parallelism over that group.  wav_scaled is this
        rank's chunk of a signal of n * its length (mesh.seq_chunk), the mel
        the whole signal's; the upsampler runs on the mel frames around the
        chunk (EncodingWindow), and the shift and every causal conv with
        fl > 1 exchange a halo with the left neighbours (conv_ops.extend),
        outside the checkpointed layer under cfg.remat, so that the
        recompute does not exchange again.  Dropout masks come from the
        generator's global draw (a mesh.RowDraws with the chunk's time).

        cfg.detail_log: ff['detail'] holds the upsampler's histograms
        (DETAIL_LOG), of the global encoding when ``hist_group`` is the data
        x seq group (each rank counts the part it owns)."""
        cfg = self.cfg
        if init and not cfg.use_weight_norm:
            raise ValueError("data-dependent init requires weight norm")
        if init and (model_group is not None or seq_group is not None):
            raise ValueError("the data-dependent init pass runs on whole params and sequences")
        dtype = None if init else self.dtype
        native = dtype is not None and inputs["wav_scaled"].is_cuda
        use_dropout = ((cfg.dropout_inputs or cfg.dropout_all) and not cfg.use_as_teacher
                       and generator is not None)
        rate = cfg.resolved_dropout_rate
        detail = {} if (cfg.detail_log and not init) else None
        new_params = dict(params)
        new_params["layers"] = list(params["layers"])

        def conv(p, x, dilation=1, extended=False):
            return conv_ops.conv1d_taps(p, x, dilation=dilation, dtype=dtype, out_dtype=dtype,
                                        native=native, seq_group=seq_group, extended=extended)

        def row(p, x):
            return conv_ops.conv1d_taps_row(p, x, model_group, dtype=dtype, out_dtype=dtype,
                                            native=native)

        def apply(p, x, dilation=1):
            if init:
                return conv_ops.conv1d_ddi(p, x, dilation=dilation)
            return conv(p, x, dilation), p

        def upsample(mel, window=None):
            return deconv_stack_train(
                params["deconv"], mel, deconv_config=cfg.deconv_config,
                upsample_act=cfg.upsample_act, use_resize_conv=cfg.use_resize_conv, init=init,
                dtype=dtype, native=native, detail=detail, window=window, hist_group=hist_group)

        x = inputs["wav_scaled"][..., None]
        if init:
            mel_en, new_params["deconv"] = upsample(inputs["mel"])
        else:
            # the 1x1 conditioning products are pointwise in time: the
            # encoding over the input's samples once, instead of trimming
            # every product
            n = mesh_lib.seq_position(seq_group)[1]
            mel_en, new_params["deconv"] = chunk_encoding(upsample, inputs["mel"], x.shape[1] * n,
                                                          cfg.deconv_config, seq_group)
            # every layer's column-parallel mel_cond product reads it: one
            # gradient sum over the model group for all of them
            mel_tp = mesh_lib.copy_to_region(mel_en, model_group)

        l = conv_ops.shift_right(x, seq_group)
        l, new_params["conv_start"] = apply(params["conv_start"], l)
        if use_dropout and cfg.dropout_all:
            l = _dropout(generator, l, rate)
        s, new_params["skip_start"] = apply(params["skip_start"], l)
        if use_dropout and cfg.dropout_inputs:
            l = _dropout(generator, l, rate)
            s = _dropout(generator, s, rate)

        m = cfg.gate_width // 2
        fl = cfg.filter_length

        def layer_body(lp, l, mel_c, dilation):
            d = (conv(lp["dilated"], mesh_lib.copy_to_region(l, model_group), dilation,
                      extended=seq_group is not None)
                 + conv(lp["mel_cond"], mel_c))
            d = _Gate.apply(d)
            return row(lp["res"], d), row(lp["skip"], d)

        for i, lp in enumerate(params["layers"]):
            dilation = 2 ** (i % cfg.num_stages)
            lp = dict(lp)
            if init:
                d, lp["dilated"] = apply(lp["dilated"], l, dilation)
                c, lp["mel_cond"] = apply(lp["mel_cond"], mel_en)
                d = condition_add(d, c)
                d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
                r, lp["res"] = apply(lp["res"], d)
                sk, lp["skip"] = apply(lp["skip"], d)
            else:
                # the halo exchange stays outside the checkpointed layer
                l_in = l if seq_group is None else conv_ops.extend(l, fl, dilation, seq_group)
                if cfg.remat:
                    r, sk = checkpoint(layer_body, lp, l_in, mel_tp, dilation, use_reentrant=False,
                                       preserve_rng_state=False)
                else:
                    r, sk = layer_body(lp, l_in, mel_tp, dilation)
            l = l + r
            s = s + sk
            if use_dropout and cfg.dropout_all:
                l = _dropout(generator, l, rate)
            new_params["layers"][i] = lp

        s, new_params["out1"] = apply(params["out1"], torch.relu(s))
        c, new_params["mel_cond_out1"] = apply(params["mel_cond_out1"], mel_en)
        s = torch.relu(condition_add(s, c))
        out, new_params["out2"] = apply(params["out2"], s)
        # the distribution heads need f32
        ff = {"encoding": mel_en, "out_params": out.float()}
        if detail is not None:
            ff["detail"] = detail
        return ff, new_params

    def calculate_loss(self, ff_dict, hist_group=None):
        """{'loss'} from 'out_params' and encode_signal's targets (the mean
        over this rank's samples).  With cfg.detail_log also ff_dict's
        'detail' histograms and, for the Gauss head, those of the mean, std
        and log std, reduced over ``hist_group``."""
        cfg = self.cfg
        out = ff_dict["out_params"]
        if cfg.loss_type == "ce":
            loss = dist.ce_loss(out, ff_dict["cate_targets"])
        elif cfg.loss_type == "mol":
            loss = dist.mol_loss(out, ff_dict["real_targets"], cfg.quant_chann)
        else:
            loss = dist.gauss_loss(out, ff_dict["real_targets"])
        ld = {"loss": loss}
        if cfg.detail_log:
            ld.update(ff_dict.get("detail", {}))
            if cfg.loss_type == "gauss":
                mean, std = dist.mean_std_from_out_params(out.detach())
                for name, t in (("mean", mean), ("std", std), ("log_std", torch.log(std))):
                    ld[f"hist/{name}"] = logging_utils.device_histogram(t, groups=hist_group)
        return ld

    def forward_loss(self, params, wav, mel, generator=None, model_group=None, seq_group=None,
                     hist_group=None):
        """wav [B, L], mel [B, T, num_mel] -> {'loss'} (a scalar tensor, the
        mean over this rank's chunk of wav under a seq group; + the
        DETAIL_LOG histograms)."""
        wav = wav[:, mesh_lib.seq_chunk(wav.shape[1], seq_group)]
        enc = self.encode_signal(wav)
        ff, _ = self.feed_forward_train(params, {"wav_scaled": enc["wav_scaled"], "mel": mel},
                                        generator=generator, model_group=model_group,
                                        seq_group=seq_group, hist_group=hist_group)
        ff.update(enc)
        return self.calculate_loss(ff, hist_group)

    @torch.no_grad()
    @no_tf32()
    def data_dep_init(self, params, wav, mel, generator=None):
        """The data-dependent init pass: returns (ff_dict, rescaled params)."""
        enc = self.encode_signal(wav)
        return self.feed_forward_train(params, {"wav_scaled": enc["wav_scaled"], "mel": mel},
                                       generator=generator, init=True)
