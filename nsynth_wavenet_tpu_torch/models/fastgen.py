"""Autoregressive WaveNet synthesis (counterpart of
nsynth_wavenet_tpu/models/fastgen.py).

``Fastgen.generate`` is the plain step loop, the counterpart of the
reference's lax.scan path: per-layer ring buffers of 2*dilation rows (slot
t mod 2d holds the t-2d state and is overwritten with the t state, slot
(t-d) mod 2d holds the t-d state), every layer's mel conditioning computed
per step by one stacked matmul, samplers drawing from a torch.Generator.

``Fastgen.generate_streaming`` chains that loop over chunks of the encoding
with the state carried (init_carry, carry_in, return_carry).

``Fastgen.generate_cuda`` is the serving path: mel -> deconv on the device
-> the whole utterance in the persistent CUDA kernel of ops/fastgen_kernel.py (the
counterpart of generate_pallas): bf16, or W8A8 with per-row scales (nothing
to calibrate) or with static scales from ``Fastgen.calibrate_act_amax``,
one-shot or in chunks with carried state.  ``Fastgen.generate_from_wav``
puts the card mel in front of it.

Over a device mesh's data axis (parallel/mesh.py), ``generate_sharded`` and
``generate_cuda_sharded`` (counterparts of jit_generate_sharded and
jit_generate_pallas_sharded) run each rank's rows of the batch and gather
the audio on every rank.
"""

from typing import Optional

import torch

from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet, condition_add, no_tf32
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import distributions as dist
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import signal as sig
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

# the odd 32-bit constant each shard of the sharded kernel path folds into
# the seed (shard index times it, in int32), as the JAX package does
SHARD_SEED_STRIDE = 0x61C88647


def shard_seed(seed: int, shard: int) -> int:
    """seed + shard * SHARD_SEED_STRIDE in int32 two's complement, JAX's
    arithmetic (jnp.int32 wraps on overflow)."""
    v = (int(seed) + int(shard) * SHARD_SEED_STRIDE) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


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

    def init_carry(self, batch: int, generator: torch.Generator, device="cuda"):
        """Fresh generation state: (zeroed ring buffers {"x", "layers"}, zero
        previous sample, the generator as the carried random state, t = 0)."""
        cfg = self.cfg
        buffers = {
            "x": torch.zeros((batch, 2, 1), device=device),
            "layers": [torch.zeros((batch, 2 * 2 ** (i % cfg.num_stages), cfg.width), device=device)
                       for i in range(cfg.num_layers)],
        }
        return (buffers, torch.zeros((batch,), device=device), generator, 0)

    @torch.no_grad()
    @no_tf32()
    def precompute_conditioning(self, params, mel):
        """mel [B, T, num_mel] -> every layer's conditioning at every step:
        (encoding [B, Te, deconv_width], cond [num_layers, B, Te, gate_width],
        cond_out1 [B, Te, skip_width]), the 1x1 products in the model's
        compute dtype, held in f32 with their biases."""
        encoding = self.model.deconv_stack(params, mel)
        dtype = self.model.dtype
        conds = [conv_ops.conv1d(lp["mel_cond"], encoding, dtype=dtype) for lp in params["layers"]]
        cond_out1 = conv_ops.conv1d(params["mel_cond_out1"], encoding, dtype=dtype)
        return encoding, torch.stack(conds), cond_out1

    @torch.no_grad()
    @no_tf32()
    def generate(self, params, mel, generator: Optional[torch.Generator] = None,
                 length: Optional[int] = None, *, teacher_force=None, cond_offset: int = 0,
                 collect_out_params: bool = False, encoding=None, carry_in=None,
                 return_carry: bool = False):
        """mel [B, T, num_mel] -> audio [B, L] (and out_params [B, L, out_width]).

        teacher_force [B, L]: feed these samples back instead of the model's
        own (as in the reference, step 0 of a call is fed zero).  cond_offset:
        start of the generated window in the upsampled conditioning (training
        centre-trims, so (enc_len - L)//2 reproduces it).
        encoding / carry_in / return_carry: streaming.  Pass an already
        upsampled encoding chunk [B, L, DW] instead of mel, and the carry of
        the previous chunk (init_carry for the first); the carry's ring
        buffers are updated in place and its generator goes on drawing, so
        chained chunks equal one call bit for bit.  With return_carry the
        result is (outputs, carry).
        """
        cfg, dtype = self.cfg, self.model.dtype
        width, gw = cfg.width, cfg.gate_width
        m, half = gw // 2, cfg.quant_chann // 2
        if encoding is None:
            encoding = self.model.deconv_stack(params, mel)
        encoding = encoding.float()
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
        if carry_in is None:
            carry_in = self.init_carry(B, generator, dev)
        buffers, prev, generator, t0 = carry_in
        xbuf, lbufs = buffers["x"], buffers["layers"]
        audio = torch.empty((B, L), device=dev)
        outs = torch.empty((B, L, cfg.out_width), device=dev) if collect_out_params else None

        def read_write(buf, t, d, new):
            """(state at t-2d, state at t-d); then slot t mod 2d <- new."""
            s2d = buf[:, t % (2 * d)].clone()
            sd = buf[:, (t - d) % (2 * d)].clone()
            buf[:, t % (2 * d)] = new
            return s2d, sd

        for t in range(L):
            tg = t + t0  # global step: the ring buffers' slot phase
            if teacher_force is not None:
                prev = teacher_force[:, t - 1].float() if t > 0 else torch.zeros_like(prev)
            x_in = (sig.mu_law(prev) / float(half) if cfg.use_mu_law else prev)[:, None]
            s2d, sd = read_write(xbuf, tg, 1, x_in)
            l = _mm(torch.cat([s2d, sd, x_in], 1), *start)
            s = _mm(l, *skip0)
            c_all = _mm(encoding[:, t + cond_offset], cond_w, cond_b)
            for i, (dil_w, rs_w) in enumerate(layers):
                s2d, sd = read_write(lbufs[i], tg, dils[i], l)
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
        out = (audio, outs) if collect_out_params else audio
        if return_carry:
            return out, (buffers, prev, generator, t0 + L)
        return out

    @torch.no_grad()
    @no_tf32()
    def generate_streaming(self, params, mel, generator: torch.Generator,
                           length: Optional[int] = None, *, chunk: int = 2000):
        """The step loop over chunks of ``chunk`` samples with the generation
        state carried (ring buffers, previous sample, generator, global step):
        equal to ``generate`` bit for bit, with per-call buffers that do not
        grow with the utterance.  The mel is upsampled once; the last chunk
        runs at its own length (eager PyTorch has no per-shape compile, so
        the reference's padding to whole chunks and its mel buckets have no
        counterpart).  Returns audio [B, L]."""
        encoding = self.model.deconv_stack(params, mel)
        B, enc_len = encoding.shape[:2]
        L = enc_len if length is None else length
        if L > enc_len:
            raise ValueError(f"length {L} exceeds conditioning length {enc_len}")
        carry = self.init_carry(B, generator, encoding.device)
        pieces = []
        for c0 in range(0, L, chunk):
            audio, carry = self.generate(params, None, encoding=encoding[:, c0 : min(c0 + chunk, L)],
                                         carry_in=carry, return_carry=True)
            pieces.append(audio)
        return torch.cat(pieces, 1)

    @torch.no_grad()
    @no_tf32()
    def calibrate_act_amax(self, params, wav, mel):
        """Per-layer abs-max of the residual stream entering each dilated
        layer, the quantity the W8A8 static mode quantises, from a
        teacher-forced f32 forward over calibration audio: wav [B, L], mel
        [B, T, num_mel] -> [num_layers] f32, for generate_cuda(act_amax=...).
        A full-length f32 forward: calibrate on a small batch (8 rows of 1 s
        is plenty), not the serving batch.  The deconv stack runs in the
        model's compute dtype and its output is widened to f32."""
        cfg = self.cfg
        enc = self.model.encode_signal(wav)
        mel_en = self.model.deconv_stack(params, mel).float()
        l = conv_ops.shift_right(enc["wav_scaled"].float()[..., None])
        l = conv_ops.conv1d(params["conv_start"], l, causal=True)
        m = cfg.gate_width // 2
        amax = []
        for i, lp in enumerate(params["layers"]):
            amax.append(l.abs().max())
            d = conv_ops.conv1d(lp["dilated"], l, dilation=2 ** (i % cfg.num_stages), causal=True)
            d = condition_add(d, conv_ops.conv1d(lp["mel_cond"], mel_en))
            d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
            l = l + conv_ops.conv1d(lp["res"], d)
        return torch.stack(amax)

    @torch.no_grad()
    @no_tf32()
    def generate_cuda(self, params, mel, seed: int, length: Optional[int] = None, *,
                      cond_offset: int = 0, kw=None, weight_dtype: str = "bf16", rs_dtype=None,
                      act_amax=None, gate_static: bool = False, int8_combine: str = "f32",
                      greedy: bool = False, chunk: Optional[int] = None, encoding=None):
        """Serving path: deconv on mel's device, then the whole utterance
        through fastgen_kernel.generate (one launch of the persistent CUDA
        kernel a call on a CUDA device).  The kernel masks the rows past B in
        its tiles.  The bf16 and static modes take any B; each per-row scale
        (of the activations, of the gate) keeps two [B] f32 arrays in a
        block's shared memory, which caps B at full width near 3 900 rows
        with one and 1 900 with both (fastgen_kernel.launch_plan raises
        above).  TF32 is off throughout,
        the deconv included.  cond_offset: start of the generated window in the
        upsampled conditioning, as in generate.

        weight_dtype "int8" is W8A8: int8 weights and ring rows.  Alone it is
        the calibration-free mode: the residual stream is quantised per batch
        row with a log8 scale whose code rides in the ring, the gate per row.
        act_amax (calibrate_act_amax) switches the residual stream to static
        per-layer scales, gate_static the gate to the fixed scale 1/127;
        rs_dtype "bf16" keeps the res/skip product in bf16 over the int8 ring
        (rs_dtype "int8" under bf16 weights is the reverse).  int8_combine
        "bf16" (per-row activation scales only): the layer's four dequantised
        sums are combined in bf16.  kw: packed weights from
        fastgen_kernel.build_kernel_weights, to pack once for many calls; it
        then decides the mode, and weight_dtype, rs_dtype, act_amax and
        gate_static are not read.
        chunk: generate in calls of ``chunk`` samples with the kernel state
        carried, equal to the one-shot call bit for bit in every mode; the
        working buffers of a call, the time-major conditioning included, then
        do not grow with the utterance (the encoding itself is read where it
        lies, one window a call).  The kernel takes any length, so the last
        chunk runs at its own length and the encoding is not padded.
        encoding [B, T, DW]: an already upsampled conditioning to use instead
        of mel.  The kernel is deterministic, so two calls on one encoding
        agree bit for bit, chunked or not; cuDNN's transposed convolution is
        not bit-stable between calls, so two calls on one mel need not.
        Returns audio [B, L] f32."""
        if kw is None:
            kw = fk.build_kernel_weights(self.cfg, params, weight_dtype=weight_dtype,
                                         rs_dtype=rs_dtype, act_amax=act_amax,
                                         gate_static=gate_static)
        if encoding is None:
            encoding = self.model.deconv_stack(params, mel)
        enc_len = encoding.shape[1]
        L = enc_len - cond_offset if length is None else length
        if L + cond_offset > enc_len:
            raise ValueError(f"window {cond_offset}+{L} exceeds conditioning length {enc_len}")
        # time-major windows of the encoding as it lies (no copy): each call's
        # pre-pass (fk.generate) makes its own window's contiguous bf16 copy
        # and, in the int8 modes, its quantised rows, so that a chunked call
        # holds one chunk of them, never the whole utterance
        enc_tm = encoding.transpose(0, 1)
        if chunk is None:
            return fk.generate(kw, enc_tm[cond_offset : cond_offset + L], seed, greedy=greedy,
                               int8_combine=int8_combine)
        state, pieces = None, []
        for c0 in range(0, L, chunk):
            win = enc_tm[cond_offset + c0 : cond_offset + min(c0 + chunk, L)]
            audio, state = fk.generate(kw, win, seed, greedy=greedy, state=state,
                                       return_state=True, int8_combine=int8_combine)
            pieces.append(audio)
        return torch.cat(pieces, 1)

    def generate_sharded(self, params, mel, generator: torch.Generator, mesh, **kw):
        """Data-parallel ``generate`` (counterpart of jit_generate_sharded):
        mel [B, T, num_mel] whole on every rank of the mesh's data axis, which
        must divide B; each rank runs its rows with the samplers' draws made
        for the whole batch (mesh.RowDraws) and the audio [B, L] is gathered
        on every rank, equal to one process's ``generate`` with the same
        generator.  kw: generate's (length, cond_offset, ...)."""
        B = mel.shape[0]
        rows = mesh_lib.rows(mesh, B)
        audio = self.generate(params, mel[rows], mesh_lib.RowDraws(generator, rows.start, B),
                              **kw)
        return torch.cat(mesh_lib.all_gather(audio, mesh.group(mesh_lib.DATA_AXIS)))

    def generate_cuda_sharded(self, params, mel, seed: int, mesh, **kw):
        """Data-parallel serving through the kernel (counterpart of
        jit_generate_pallas_sharded): mel [B, T, num_mel] (or kw['encoding'])
        whole on every rank of the mesh's data axis, which must divide B;
        rank r calls generate_cuda on its rows with shard_seed(seed, r), so
        that shards draw other noise, and the audio [B, L] is gathered on
        every rank.  Greedy mode draws nothing and equals one process's
        generate_cuda bit for bit; a rank's sampled rows equal generate_cuda
        on those rows with the folded seed.  Every mode of generate_cuda
        passes through kw (bf16, W8A8 static or per row, chunk, greedy).  The
        kernel masks the rows past a rank's batch in its tiles, so a rank's
        batch need not be a multiple of 8 (the TPU kernel's tile)."""
        B = (mel if mel is not None else kw["encoding"]).shape[0]
        rows = mesh_lib.rows(mesh, B)
        if kw.get("encoding") is not None:
            kw = dict(kw, encoding=kw["encoding"][rows])
        audio = self.generate_cuda(params, None if mel is None else mel[rows],
                                   shard_seed(seed, mesh.index(mesh_lib.DATA_AXIS)), **kw)
        return torch.cat(mesh_lib.all_gather(audio, mesh.group(mesh_lib.DATA_AXIS)))

    def generate_from_wav(self, params, wav, seed: int, **kw):
        """Raw wav batch [B, N] -> the mel on wav's device (stft.melspectrogram)
        -> generate_cuda(params, mel, seed, **kw): the kernel path on a CUDA
        tensor, its plain version on a CPU one."""
        return self.generate_cuda(params, stft_ops.melspectrogram(wav), seed, **kw)
