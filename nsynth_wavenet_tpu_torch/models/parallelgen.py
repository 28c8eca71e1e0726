"""One-shot parallel (IAF) synthesis (counterpart of
nsynth_wavenet_tpu/models/parallelgen.py): mel -> base noise -> IAF flows ->
clip / quantize -> audio.

Three compute paths:
  * plain (``synthesize``): ParallelWavenet.feed_forward as it is;
  * fused (``feed_forward_cuda`` / ``synthesize_cuda``, and
    ``synthesize_from_wav`` with the card mel in front), the serving path: each
    flow's dilated trunk runs as chained ops/flow_kernel.flow_stack calls, one
    per num_stages-layer dilation cycle (``layers_per_call`` fuses whole
    cycles), with the per-layer mel conditioning computed in the kernel from
    the raw deconv encoding: in bf16 for a bf16 model (the compact mode), in
    f32 for an f32 model (``fuse_cond`` folds it into the tap product in bf16
    for either).  The whole path is time-major ([L, B, ...]) with one
    transpose of the encoding; the start conv, the out heads and the f32 flow
    composition are stock PyTorch, run with TF32 off;
  * streaming (``StudentStreamer``): the fused path chunk by chunk with the
    dilation history carried across calls, for any utterance length at a
    bounded working set.
On CPU tensors flow_stack runs its plain version, so all three run there.

Over a device mesh (parallel/mesh.py): ``synthesize_sharded`` splits the
batch over the data axis, each rank running what one process runs for its
rows (the fused path on the card, the plain one on the CPU) from its rows of
the whole batch's base noise; ``synthesize_seq_sharded`` splits time over the
seq axis, each rank running the plain flows on its chunk with a
receptive-field halo from its left neighbour.

The fused twin keeps its own roundings, which differ from the plain path's:
the start conv is three f32 outer products, the trunk stream stays f32, and
the mean and scale heads come out unrounded in f32.
"""

import torch

from nsynth_wavenet_tpu_torch.models.parallel_wavenet import (SCALE_MAX, ParallelWavenet,
                                                            compose_output)
from nsynth_wavenet_tpu_torch.models import wavenet as wavenet_lib
from nsynth_wavenet_tpu_torch.models.wavenet import no_tf32
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import flow_kernel as flow_kernel_ops
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib


@torch.no_grad()
@no_tf32()
def synthesize(pwn: ParallelWavenet, params, mel, generator):
    """mel [B, T, num_mel] -> audio [B, L], L snapped to a multiple of
    max_dilation.  The plain path, with TF32 off as in feed_forward_cuda."""
    return pwn._clip_quant_scale(pwn.feed_forward(params, {"mel": mel}, generator)["x"])


# ---------------------------------------------------------------------------
# Fused serving path
# ---------------------------------------------------------------------------


def _trim_to(enc, length):
    """Centre-trim the deconv encoding [B, T, C] to the sample length: the
    slice condition_add takes, hoisted since every cond conv is 1x1."""
    left = (enc.shape[1] - length) // 2
    return enc[:, left : left + length]


def _mm_1x1(p, x, dtype, out_dtype=None):
    """1x1 conv as a channels-last matmul on a time-major stream: operands
    rounded to ``dtype``, f32 accumulation, the product rounded to
    ``out_dtype`` when given and the bias added in that type."""
    w = conv_ops.effective_kernel(p)[0]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = x.float() @ w.float()
    if out_dtype is not None:
        y = y.to(out_dtype)
    return y + p["b"].to(y.dtype)


def _flow_weights(flow_params, compact):
    """Kernel-layout trunk weights of one flow."""
    sw = flow_kernel_ops.stack_flow_weights(flow_params)
    return (flow_kernel_ops.compact_weights if compact else flow_kernel_ops.noncompact_weights)(sw)


def _start_conv(flow_params, xh):
    """shift_right + filter-3 causal start conv over the 1-channel input as
    three shifted outer products in f32.  xh [3 + L, B, 1]: the three samples
    before the stream, then the stream; l[t] = sum_k w[k] * x[t - 3 + k] + b."""
    w = conv_ops.effective_kernel(flow_params["start_conv"])  # [3, 1, W]
    L = xh.shape[0] - 3
    l = xh[0:L] * w[0, 0] + xh[1 : 1 + L] * w[1, 0] + xh[2 : 2 + L] * w[2, 0]
    return l + flow_params["start_conv"]["b"]


def _flow_heads(pwn, flow_params, l, enc_tm):
    """Out heads of one flow on the time-major trunk output: (mean, scale,
    log_scale), each [L, B, 1] f32 and unrounded."""
    dtype = pwn.dtype
    l = torch.relu(l if dtype is None else l.to(dtype))
    l = _mm_1x1(flow_params["out1"], l, dtype, dtype)
    l = torch.relu(l + _mm_1x1(flow_params["mel_cond_out1"], enc_tm, dtype, dtype))
    mean = _mm_1x1(flow_params["out2_mean"], l, dtype)
    scale, log_scale = pwn.scale_log_scale(_mm_1x1(flow_params["out2_scale"], l, dtype))
    return mean, scale, log_scale


def _iaf_flow_cuda(pwn, flow_params, sw, x, xh, enc_tm, flow_idx, compact, state=None, *,
                   group=0, fuse_cond=False):
    """One IAF flow with the dilated trunk in the flow kernel, time-major.
    x [L, B, 1] f32, xh [3, B, 1] the three samples before it, enc_tm
    [L, B, DW] in the kernel's conditioning dtype, state: the flow's list of
    per-cycle trunk states or None; group: layers per kernel call (0: one
    dilation cycle).  Returns (mean, scale, log_scale, new trunk states)."""
    cfg = pwn.cfg
    l = _start_conv(flow_params, torch.cat([xh, x], 0)).contiguous()
    n_layers = cfg.num_iaf_layers[flow_idx]
    group = group or cfg.num_stages
    enc_k = enc_tm
    if fuse_cond:  # its product rounds both to bf16 in every mode: once a flow, not once a call
        enc_k = enc_tm.to(torch.bfloat16)
        sw = dict(sw, w_cond=sw["w_cond"].to(torch.bfloat16))
    new_state = []
    for gi, s in enumerate(range(0, n_layers, group)):
        nl = min(group, n_layers - s)
        if state is None:
            l = flow_kernel_ops.flow_stack(l, enc_k, sw, s, nl, cfg.num_stages, compact=compact,
                                           fuse_cond=fuse_cond)
        else:
            l, g = flow_kernel_ops.flow_stack(l, enc_tm, sw, s, nl, cfg.num_stages,
                                              state=state[gi], compact=compact)
            new_state.append(g)
    return (*_flow_heads(pwn, flow_params, l, enc_tm), new_state)


def _enc_tm(pwn, params, flow_idx, mel, length, compact):
    """Flow flow_idx's deconv encoding of mel, trimmed to the sample length and
    transposed once to time-major [length, B, DW] in the kernel's conditioning
    dtype."""
    enc = _trim_to(pwn._flow_deconv(params, flow_idx, mel), length)
    return enc.transpose(0, 1).to(torch.bfloat16 if compact else torch.float32).contiguous()


def _compact(pwn):
    """The kernel mode follows the model's compute dtype: a bf16 model runs the
    compact kernel (bf16 encoding and weight storage), an f32 model keeps the
    conditioning product in f32."""
    return pwn.dtype == torch.bfloat16


@torch.no_grad()
@no_tf32()
def feed_forward_cuda(pwn: ParallelWavenet, params, inputs, generator=None, *,
                      layers_per_call=0, fuse_cond=False):
    """ParallelWavenet.feed_forward with the flow trunks in the flow kernel.
    Same contract: inputs {'mel'} (+ optional 'base_x'), returns the ff dict.

    layers_per_call: layers per kernel call, a multiple of num_stages (0: one
    dilation cycle); the same arithmetic in fewer calls, so the output is the
    same bit for bit.  fuse_cond: the reference's single K = 3W + DW bf16
    product per layer, the encoding and w_cond rounded to bf16 even for an f32
    model (the kernel's compact arithmetic).  Runs with TF32 off, so an f32
    model's deconv and heads are f32.  On the card each trunk layer is one
    CUDA launch of the kernel of the model's width (flow_stack picks by width
    alone): flow_persist_kernel at W 32 and 64, flow_wide_kernel at W 128
    and 256."""
    group = layers_per_call or pwn.cfg.num_stages
    if group % pwn.cfg.num_stages:
        raise ValueError(f"layers_per_call {layers_per_call} is not a multiple of num_stages "
                         f"{pwn.cfg.num_stages}")
    compact = _compact(pwn)
    mel = inputs["mel"]
    x = pwn.resolve_base_x(inputs, generator)
    B, length = x.shape
    shared_enc_tm = _enc_tm(pwn, params, 0, mel, length, compact) if pwn.shares_deconv else None
    x_tm = x.t()[..., None]  # [L, B, 1] f32
    xh0 = x_tm.new_zeros((3, B, 1))
    iaf_x = x_tm
    mean_tot, scale_tot, log_scale_tot = 0.0, 1.0, 0.0
    for fi, fp in enumerate(params["flows"]):
        enc_tm = (shared_enc_tm if shared_enc_tm is not None
                  else _enc_tm(pwn, params, fi, mel, length, compact))
        mean, scale, log_scale, _ = _iaf_flow_cuda(
            pwn, fp, _flow_weights(fp, compact), iaf_x, xh0, enc_tm, fi, compact, group=group,
            fuse_cond=fuse_cond)
        iaf_x = iaf_x * scale + mean
        mean_tot = mean + mean_tot * scale
        scale_tot = scale_tot * scale
        log_scale_tot = log_scale_tot + log_scale
    # [L, B, 1] -> [B, L]
    return compose_output(x, mean_tot[..., 0].t(), scale_tot[..., 0].t(),
                          log_scale_tot[..., 0].t())


@torch.no_grad()
def synthesize_cuda(pwn: ParallelWavenet, params, mel, generator, **kw):
    """Fused twin of ``synthesize`` (same mel -> audio contract); kw:
    feed_forward_cuda's layers_per_call and fuse_cond."""
    return pwn._clip_quant_scale(feed_forward_cuda(pwn, params, {"mel": mel}, generator, **kw)["x"])


def synthesize_from_wav(pwn: ParallelWavenet, params, wav, generator, **kw):
    """Raw wav batch [B, N] -> the mel on wav's device (stft.melspectrogram)
    -> synthesize_cuda(pwn, params, mel, generator, **kw)."""
    return synthesize_cuda(pwn, params, stft_ops.melspectrogram(wav), generator, **kw)


class StudentStreamer:
    """Any-length one-shot IAF serving in chunks of ``chunk`` samples.

    The mel is deconv-encoded once, as the one-shot path encodes it (eager
    convolutions take any length, so nothing is padded to a bucket), and the
    flow trunks run chunk by chunk
    through flow_stack with the dilation history carried across calls: the
    chunked run repeats the one-shot kernel's arithmetic row for row on the
    same base noise, at a working set of one chunk instead of one utterance.
    State per flow: the packed trunk histories (one per dilation cycle) and
    the last 3 input samples (the start conv's window); the out heads and the
    flow composition are pointwise and need none.  The last chunk is as short
    as the utterance leaves it (the kernel takes any length).

    Base noise is drawn per chunk from the generator, so audio differs from
    the one-shot path's full-length draw by noise realization only; pass
    base_x to pin the noise.

    The kernel-layout weights are restacked from ``params`` on every
    ``synthesize`` call (a few dozen small tensor ops), not cached: tensors
    mutate in place, and a cache keyed on identity would serve stale weights.
    """

    def __init__(self, pwn: ParallelWavenet, *, chunk: int = 32768):
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.pwn = pwn
        self.chunk = chunk
        self.compact = _compact(pwn)

    def _flow_encs(self, params, mel, length):
        """Per flow the time-major encoding [length, B, DW] in the kernel's
        conditioning dtype; a shared deconv yields one object for all."""
        pwn = self.pwn
        if pwn.shares_deconv:
            return [_enc_tm(pwn, params, 0, mel, length, self.compact)] * pwn.num_flows
        return [_enc_tm(pwn, params, fi, mel, length, self.compact)
                for fi in range(pwn.num_flows)]

    def init_state(self, batch, device):
        """Fresh causal-zero state: per flow {'xh' [3, B, 1], 'trunk': one
        [state_rows, B, W] f32 per dilation cycle}."""
        cfg = self.pwn.cfg
        state = []
        for n_layers in cfg.num_iaf_layers:
            trunk = [
                torch.zeros((flow_kernel_ops.state_rows(s, min(cfg.num_stages, n_layers - s),
                                                        cfg.num_stages), batch, cfg.width),
                            device=device)
                for s in range(0, n_layers, cfg.num_stages)
            ]
            state.append({"xh": torch.zeros((3, batch, 1), device=device), "trunk": trunk})
        return state

    def _chunk_step(self, params, stacked, x_tm, encs, state):
        """One chunk through every flow.  x_tm [C, B, 1] f32 base noise, encs:
        per-flow [C, B, DW] chunks.  Returns (audio [C, B], new state)."""
        pwn = self.pwn
        new_state = []
        iaf_x = x_tm
        mean_tot, scale_tot = 0.0, 1.0
        for fi, fp in enumerate(params["flows"]):
            st = state[fi]
            mean, scale, _, trunk = _iaf_flow_cuda(
                pwn, fp, stacked[fi], iaf_x, st["xh"], encs[fi], fi, self.compact,
                state=st["trunk"])
            new_state.append({"xh": torch.cat([st["xh"], iaf_x], 0)[-3:], "trunk": trunk})
            iaf_x = iaf_x * scale + mean
            mean_tot = mean + mean_tot * scale
            scale_tot = scale_tot * scale
        x = x_tm * torch.clamp(scale_tot, max=SCALE_MAX) + mean_tot
        return pwn._clip_quant_scale(x[..., 0]), new_state

    @torch.no_grad()
    @no_tf32()
    def synthesize(self, params, mel, generator=None, base_x=None):
        """mel [B, T, num_mel] -> audio [B, L] on mel's device (L snapped like
        the one-shot path).  One streamer object serves every length.  Runs
        with TF32 off, as feed_forward_cuda does."""
        pwn = self.pwn
        B, T, _ = mel.shape
        L = pwn.sample_length(T)
        if base_x is not None:
            base_x = pwn.resolve_base_x({"mel": mel, "base_x": base_x}, None).to(mel.device)
        elif generator is None:
            raise ValueError("synthesize needs a generator or base_x")
        encs = self._flow_encs(params, mel, L)
        stacked = [_flow_weights(fp, self.compact) for fp in params["flows"]]
        state = self.init_state(B, mel.device)
        outs = []
        for c0 in range(0, L, self.chunk):
            C = min(self.chunk, L - c0)
            x_c = (pwn.base_noise(generator, B, C, mel.device) if base_x is None
                   else base_x[:, c0 : c0 + C])
            enc_cs = [e[c0 : c0 + C] for e in encs]
            audio, state = self._chunk_step(params, stacked, x_c.t()[..., None], enc_cs, state)
            outs.append(audio)
        return torch.cat(outs, 0).t().contiguous()


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------


def synthesize_sharded(pwn: ParallelWavenet, params, mel, generator, mesh, fused=None, **kw):
    """Data-parallel one-shot serving (counterpart of
    jit_synthesize_sharded): mel [B, T, num_mel] whole on every rank of the
    mesh's data axis, which must divide B.  Each rank runs its rows through
    synthesize_cuda (fused; kw: its layers_per_call, fuse_cond) or the plain
    synthesize, with its rows of the whole batch's base noise
    (mesh.RowDraws), and the audio [B, L] is gathered on every rank: one
    process's audio on the same path to one quantisation bin.  fused
    defaults to the fused path on a CUDA device and the plain one on the CPU,
    the path JAX's jit_synthesize_sharded runs there."""
    B = mel.shape[0]
    rows = mesh_lib.rows(mesh, B)
    draws = mesh_lib.RowDraws(generator, rows.start, B)
    if mel.is_cuda if fused is None else fused:
        audio = synthesize_cuda(pwn, params, mel[rows], draws, **kw)
    else:
        audio = synthesize(pwn, params, mel[rows], draws)
    return torch.cat(mesh_lib.all_gather(audio, mesh.group(mesh_lib.DATA_AXIS)))


def flow_receptive_field(pwn: ParallelWavenet, flow_idx: int) -> int:
    """Samples before t that a flow's output at t reads: the shift by one,
    the start conv's taps and every dilated layer's (the heads are 1x1)."""
    cfg = pwn.cfg
    dils = sum(2 ** (i % cfg.num_stages) for i in range(cfg.num_iaf_layers[flow_idx]))
    return 1 + (cfg.filter_length - 1) * (1 + dils)


@torch.no_grad()
@no_tf32()
def synthesize_seq_sharded(pwn: ParallelWavenet, params, mel, generator, mesh):
    """Time-sharded one-shot serving (counterpart of
    jit_synthesize_seq_sharded): mel [B, T, num_mel] whole on every rank;
    rank r of the seq axis owns samples [r L/n, (r+1) L/n) of each row (and
    its data index its rows of the batch), with T and the sample length L
    multiples of n.  Every flow of the plain path runs on the chunk extended
    on the left by the flow's receptive field (flow_receptive_field), whose
    input the left neighbour sends (one send/receive a flow), and the
    extension's outputs are dropped; the upsampling stack runs on the mel
    frames of that window with a halo of frames each side.  The base noise
    is the whole batch's draw.  Returns audio [B, L] on every rank: the
    plain ``synthesize`` to one quantisation bin."""
    cfg = pwn.cfg
    B, T = mel.shape[:2]
    L = pwn.sample_length(T)
    n, r = mesh.size(mesh_lib.SEQ_AXIS), mesh.index(mesh_lib.SEQ_AXIS)
    if T % n or L % n:
        raise ValueError(f"mel frames ({T}) and sample length ({L}) must divide the seq axis "
                         f"({n}); crop the mel to a multiple")
    rows = mesh_lib.rows(mesh, B)
    seq_group = mesh.group(mesh_lib.SEQ_AXIS)
    chunk = L // n
    t0, t1 = r * chunk, (r + 1) * chunk
    reach = [flow_receptive_field(pwn, fi) for fi in range(pwn.num_flows)]
    if max(reach) > chunk:
        raise ValueError(f"a flow reads {max(reach)} samples back, more than a chunk ({chunk})")
    halos = [R if r > 0 else 0 for R in reach]
    x = pwn.base_noise(mesh_lib.RowDraws(generator, rows.start, B), rows.stop - rows.start, L,
                       mel.device)[:, t0:t1]

    # the encoding over [t0 - max halo, t1), from a window of mel frames
    fs = cfg.frame_shift
    left = (T * fs - L) // 2
    e0, e1 = t0 - max(halos) + left, t1 + left
    hf = wavenet_lib.deconv_halo_frames(cfg.deconv_config)
    fa, fb = max(0, e0 // fs - hf), min(T, -(-e1 // fs) + hf)
    mel_w = mel[rows, fa:fb]
    shared = pwn._flow_deconv(params, 0, mel_w) if pwn.shares_deconv else None

    iaf_x = x[..., None]
    mean_tot, scale_tot, log_scale_tot = 0.0, 1.0, 0.0
    for fi, fp in enumerate(params["flows"]):
        h, R = halos[fi], reach[fi]
        halo = (mesh_lib.send_right_recv_left(iaf_x[:, chunk - R:], seq_group, iaf_x[:, :R])
                if n > 1 else None)
        x_ext = iaf_x if halo is None else torch.cat([halo, iaf_x], 1)
        enc = shared if shared is not None else pwn._flow_deconv(params, fi, mel_w)
        enc = enc[:, t0 - h + left - fa * fs : t1 + left - fa * fs]
        iaf = {k: v[:, h:] for k, v in pwn._create_iaf(fp, x_ext, enc, fi).items()}
        iaf_x = iaf["x"]
        mean_tot = iaf["mean"] + mean_tot * iaf["scale"]
        scale_tot = scale_tot * iaf["scale"]
        log_scale_tot = log_scale_tot + iaf["log_scale"]
    ff = compose_output(x, mean_tot[..., 0], scale_tot[..., 0], log_scale_tot[..., 0])
    audio = torch.cat(mesh_lib.all_gather(pwn._clip_quant_scale(ff["x"]), seq_group), 1)
    return torch.cat(mesh_lib.all_gather(audio, mesh.group(mesh_lib.DATA_AXIS)))
