"""Whole-utterance autoregressive generation through the hand-written CUDA
kernel ``csrc/fastgen_kernel.cu`` (port of the Pallas TPU kernel
nsynth_wavenet_tpu/ops/fastgen_kernel.py make_generate_fn, bf16 weights).

``generate`` is the wrapper: on CUDA tensors it launches the kernel (and
raises if it cannot), on CPU tensors it runs ``generate_plain``, the plain
PyTorch version with the same signature and the same arithmetic: bf16
matrices, f32 accumulation, f32 gate, and bf16 operands rounded at the same
places.  Random draws come from a Philox4x32-10 counter generator keyed by
(seed, t, batch row, lane); ``philox_uniform_plain`` implements it in torch
integer ops so kernel and plain version draw identical uniforms.
"""

import ctypes
import math

import torch

LANE = 16  # head segments are padded to the tensor-core tile width
HEADS = {"ce": 0, "mol": 1, "gauss": 2}

M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _round_up(x, m):
    return (x + m - 1) // m * m


def dilations(cfg):
    return [2 ** (i % cfg.num_stages) for i in range(cfg.num_layers)]


def ring_offsets(cfg):
    """First ring row of every layer and the total: layer i owns 2*d_i rows."""
    offs, total = [], 0
    for d in dilations(cfg):
        offs.append(total)
        total += 2 * d
    return offs, total


def head_layout(cfg):
    """(out_seg, out_pad): MoL is [logits|pad][means|pad][scales|pad] with
    out_seg-wide segments; CE and Gauss are one out_pad-wide segment."""
    if cfg.loss_type == "mol":
        seg = _round_up(cfg.mol_mix, LANE)
        return seg, 3 * seg
    pad = _round_up(cfg.out_width, LANE)
    return pad, pad


def _k2d(p):
    from nsynth_wavenet_tpu_torch.ops.conv import effective_kernel

    w = effective_kernel(p)
    return w.reshape(w.shape[0] * w.shape[1], w.shape[2])


def build_kernel_weights(cfg, params):
    """Pack the teacher's params into the kernel's bf16 layout.

    w_comb [NL, 3W+DW, GW]: dilated taps (t-2d, t-d, t) stacked over the
    mel-cond 1x1, with b_comb the sum of both biases; w_rs [NL, m, W+S];
    w_out1 [S+DW, S] with the out1 mel-cond stacked under out1; w_out2
    [S, out_pad] in the head_layout, padded logit lanes biased to -1e9.
    """
    if cfg.filter_length != 3:
        raise ValueError("the generation kernel needs filter_length 3")
    skip = cfg.skip_width
    seg, out_pad = head_layout(cfg)
    w_comb, b_comb, w_rs, b_rs = [], [], [], []
    for lp in params["layers"]:
        w_comb.append(torch.cat([_k2d(lp["dilated"]), _k2d(lp["mel_cond"])], 0))
        b_comb.append(lp["dilated"]["b"] + lp["mel_cond"]["b"])
        w_rs.append(torch.cat([_k2d(lp["res"]), _k2d(lp["skip"])], 1))
        b_rs.append(torch.cat([lp["res"]["b"], lp["skip"]["b"]]))

    w2, b2 = _k2d(params["out2"]), params["out2"]["b"]
    dev = w2.device
    w_out2 = torch.zeros((skip, out_pad), device=dev)
    b_out2 = torch.zeros((out_pad,), device=dev)
    if cfg.loss_type == "mol":
        nr = cfg.mol_mix
        for k in range(3):
            w_out2[:, k * seg : k * seg + nr] = w2[:, k * nr : (k + 1) * nr]
            b_out2[k * seg : k * seg + nr] = b2[k * nr : (k + 1) * nr]
        b_out2[nr:seg] = -1e9  # padded logit lanes never win the argmax
    else:
        w_out2[:, : cfg.out_width] = w2
        b_out2[: cfg.out_width] = b2
        if cfg.loss_type == "ce":
            b_out2[cfg.out_width :] = -1e9

    bf = torch.bfloat16
    return {
        "cfg": cfg,
        "w_comb": torch.stack(w_comb).to(bf).contiguous(),
        "b_comb": torch.stack(b_comb).float().contiguous(),
        "w_rs": torch.stack(w_rs).to(bf).contiguous(),
        "b_rs": torch.stack(b_rs).float().contiguous(),
        "w_start": _k2d(params["conv_start"]).float().contiguous(),
        "b_start": params["conv_start"]["b"].float().contiguous(),
        "w_skip0": _k2d(params["skip_start"]).to(bf).contiguous(),
        "b_skip0": params["skip_start"]["b"].float().contiguous(),
        "w_out1": torch.cat([_k2d(params["out1"]), _k2d(params["mel_cond_out1"])], 0)
        .to(bf).contiguous(),
        "b_out1": (params["out1"]["b"] + params["mel_cond_out1"]["b"]).float().contiguous(),
        "w_out2": w_out2.to(bf).contiguous(),
        "b_out2": b_out2.contiguous(),
    }


def unpack_head(cfg, out_params):
    """[..., out_pad] kernel head -> [..., out_width] in the reference layout."""
    seg, _ = head_layout(cfg)
    if cfg.loss_type == "mol":
        nr = cfg.mol_mix
        return torch.cat([out_params[..., k * seg : k * seg + nr] for k in range(3)], -1)
    return out_params[..., : cfg.out_width]


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch integer ops (bit-identical to csrc/fastgen_kernel.cuh)
# ---------------------------------------------------------------------------


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m for int64 tensors a in [0, 2^32) and a
    32-bit constant m, with every partial product inside int64."""
    ah, al = a >> 16, a & 0xFFFF
    mh, ml = m >> 16, m & 0xFFFF
    mid = ah * ml + al * mh
    low = al * ml + ((mid & 0xFFFF) << 16)
    return (ah * mh + (mid >> 16) + (low >> 32)) & M32, low & M32


def philox_bits(c0, c1, c2, c3, seed: int):
    """First output word of Philox4x32-10 for counter (c0, c1, c2, c3), int64
    tensors (or ints) broadcast together, key (seed low, seed high)."""
    k0, k1 = seed & M32, (seed >> 32) & M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & M32, (k1 + _PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def uniform_from_bits(bits):
    """Top 24 bits of an unsigned word -> f32 uniform on [1e-5, 1 - 1e-5]."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, 1e-5, 1.0 - 1e-5)


def philox_uniform_plain(seed: int, t, rows: int, lanes: int, draw: int, device="cpu"):
    """Uniforms at counter (lane, row, t, draw): [rows, lanes] for an int t,
    [len(t), rows, lanes] for a sequence of steps t."""
    steps = torch.as_tensor(t, dtype=torch.int64, device=device)
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    shape = (*steps.shape, rows, lanes)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    steps = steps.reshape(*steps.shape, 1, 1)
    return uniform_from_bits(philox_bits(lane + zero, row + zero, steps + zero, zero + draw, seed))


def philox_uniform(seed: int, t: int, rows: int, lanes: int, draw: int, device="cuda"):
    """Uniforms from the kernel's own generator: launches the CUDA kernel for a
    CUDA device, runs philox_uniform_plain for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_uniform_plain(seed, t, rows, lanes, draw, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((rows, lanes), dtype=torch.float32, device=device)
    lib = _lib()
    rc = lib.philox_uniform(out.data_ptr(), rows, lanes, t, draw, seed, out.device.index,
                            torch.cuda.current_stream(out.device).cuda_stream)
    _check(lib, rc)
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _bf(x):
    """Round to bf16 and hold as f32 (the kernel's matmul operands)."""
    return x.to(torch.bfloat16).float()


def _draw_lanes(cfg):
    """Lanes of the first draw per step: every logit for CE, every mixture
    logit lane for MoL, one for Gauss.  The second draw always has one lane."""
    seg, out_pad = head_layout(cfg)
    return {"ce": out_pad, "mol": seg, "gauss": 1}[cfg.loss_type]


def _sample(cfg, out, u1, u2, greedy):
    """Head output [B, out_pad] f32 and the step's uniforms u1 [B, lanes],
    u2 [B] -> audio [B] f32."""
    seg, _ = head_layout(cfg)
    half = float(cfg.quant_chann // 2)
    if cfg.loss_type == "gauss":
        x = out[:, 0]
        if not greedy:
            z = torch.sqrt(-2.0 * torch.log(u1[:, 0])) * torch.cos(2.0 * math.pi * u2)
            x = x + torch.exp(torch.clamp(out[:, 1], min=-7.0)) * z
    else:
        scores = out[:, : u1.shape[1]]
        if not greedy:
            scores = scores - torch.log(-torch.log(u1))
        idx = torch.argmax(scores, dim=1, keepdim=True)
        if cfg.loss_type == "mol":
            x = torch.gather(out[:, seg : 2 * seg], 1, idx)[:, 0]
            if not greedy:
                log_sc = torch.clamp(torch.gather(out[:, 2 * seg :], 1, idx)[:, 0], -7.0, 7.0)
                x = x + torch.exp(log_sc) * (torch.log(u2) - torch.log(1.0 - u2))
        else:
            qv = idx[:, 0].float() - half
    if cfg.loss_type != "ce":
        x = torch.clamp(x, -1.0, 1.0 - 2.0 / cfg.quant_chann)
        qv = torch.floor(x * half)
    if cfg.use_mu_law:
        y = (qv + 0.5) * 2.0 / 256.0
        audio = torch.sign(y) / 255.0 * (torch.pow(256.0, torch.abs(y)) - 1.0)
        return torch.where(qv == 0, torch.zeros_like(audio), audio)
    return qv / half


def _draws(cfg, seed, L, B, device):
    """Per step t < L: (u1 [B, lanes], u2 [B]), made many steps at a time."""
    lanes = _draw_lanes(cfg)
    chunk = max(1, (1 << 20) // (B * lanes))
    for t0 in range(0, L, chunk):
        steps = range(t0, min(t0 + chunk, L))
        u1 = philox_uniform_plain(seed, steps, B, lanes, 0, device)
        u2 = philox_uniform_plain(seed, steps, B, 1, 1, device)[..., 0]
        yield from zip(u1, u2)


@torch.no_grad()
def resample_plain(cfg, out_params, seed, *, greedy=False):
    """The sampler alone: head outputs [B, L, out_pad] (e.g. collected from a
    kernel run) -> the audio [B, L] that run must have drawn with this seed."""
    B, L, _ = out_params.shape
    draws = _draws(cfg, seed, L, B, out_params.device)
    return torch.stack([_sample(cfg, out_params[:, t], *next(draws), greedy) for t in range(L)], 1)


@torch.no_grad()
def generate_plain(kw, enc_t, seed, *, greedy=False, tf=None, collect_out_params=False):
    """Plain PyTorch version of the kernel (see ``generate``)."""
    cfg = kw["cfg"]
    L, B, _ = enc_t.shape
    dev = enc_t.device
    W, S = cfg.width, cfg.skip_width
    m = cfg.gate_width // 2
    half = float(cfg.quant_chann // 2)
    dils = dilations(cfg)
    offs, slots = ring_offsets(cfg)
    f32 = {k: v.float() for k, v in kw.items() if isinstance(v, torch.Tensor)}
    w_start = f32["w_start"]

    enc_t = enc_t.to(torch.bfloat16).float()
    lbuf = torch.zeros((slots, B, W), dtype=torch.bfloat16, device=dev)
    xh = torch.zeros((3, B), device=dev)
    audio = torch.empty((L, B), device=dev)
    outp = torch.empty((L, B, f32["w_out2"].shape[1]), device=dev) if collect_out_params else None
    draws = _draws(cfg, seed, L, B, dev)
    for t in range(L):
        enc = enc_t[t]
        l = (xh[0][:, None] * w_start[0] + xh[1][:, None] * w_start[1]
             + xh[2][:, None] * w_start[2] + f32["b_start"])
        s = _bf(l) @ f32["w_skip0"] + f32["b_skip0"]
        for li, d in enumerate(dils):
            r2 = offs[li] + t % (2 * d)
            r1 = offs[li] + (t + d) % (2 * d)
            stack = torch.cat([lbuf[r2].float(), lbuf[r1].float(), _bf(l), enc], 1)
            dpre = stack @ f32["w_comb"][li] + f32["b_comb"][li]
            gate = torch.sigmoid(dpre[:, :m]) * torch.tanh(dpre[:, m:])
            rs = _bf(gate) @ f32["w_rs"][li] + f32["b_rs"][li]
            lbuf[r2] = l.to(torch.bfloat16)
            l = l + rs[:, :W]
            s = s + rs[:, W:]
        o1 = torch.relu(torch.cat([_bf(torch.relu(s)), enc], 1) @ f32["w_out1"] + f32["b_out1"])
        out = _bf(o1) @ f32["w_out2"] + f32["b_out2"]
        if outp is not None:
            outp[t] = out
        audio[t] = _sample(cfg, out, *next(draws), greedy)
        fb = tf[t].float() if tf is not None else audio[t]
        if cfg.use_mu_law:
            fb = torch.floor(torch.sign(fb) * torch.log1p(255.0 * torch.abs(fb))
                             / math.log(256.0) * 128.0) / half
        xh = torch.stack([xh[1], xh[2], fb])
    audio = audio.T.contiguous()
    if collect_out_params:
        return audio, outp.transpose(0, 1).contiguous()
    return audio


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


class _FastgenArgs(ctypes.Structure):
    """Mirror of struct FastgenArgs in csrc/fastgen_kernel.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_comb", "b_comb", "w_rs", "b_rs", "w_start", "b_start", "w_skip0", "b_skip0",
        "w_out1", "b_out1", "w_out2", "b_out2", "enc", "tf", "lbuf", "l", "l_bf", "s", "gate",
        "part", "counters", "xh", "audio", "out_params", "stream",
    )] + [("seed", ctypes.c_longlong)] + [(name, ctypes.c_int) for name in (
        "device", "B", "L", "W", "GW", "S", "DW", "NL", "num_stages",
        "out_pad", "out_seg", "head", "use_mu_law", "quant_chann", "greedy",
    )]


def _lib():
    from nsynth_wavenet_tpu_torch.kernels import build

    lib = build.load("fastgen_kernel")
    if not getattr(lib, "_argtypes_set", False):
        lib.fastgen_generate.argtypes = [ctypes.POINTER(_FastgenArgs)]
        lib.fastgen_generate.restype = ctypes.c_int
        lib.fastgen_workspace.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        lib.fastgen_workspace.restype = None
        lib.philox_uniform.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.philox_uniform.restype = ctypes.c_int
        lib.fastgen_error_string.argtypes = [ctypes.c_int]
        lib.fastgen_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, rc):
    if rc != 0:
        msg = lib.fastgen_error_string(rc).decode()
        raise RuntimeError(f"CUDA generation kernel failed: {msg} (cudaError {rc})")


def _expect(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{name} must be contiguous and 32-byte aligned")


def _generate_cuda(kw, enc_t, seed, greedy, tf, collect_out_params):
    cfg = kw["cfg"]
    L, B, DW = enc_t.shape
    W, GW, S, NL = cfg.width, cfg.gate_width, cfg.skip_width, cfg.num_layers
    m = GW // 2
    seg, out_pad = head_layout(cfg)
    if DW != cfg.deconv_width:
        raise ValueError(f"enc_t width {DW} != deconv_width {cfg.deconv_width}")
    for name, v in (("width", W), ("skip_width", S), ("deconv_width", DW), ("gate_width/2", m)):
        if v % 64:
            raise ValueError(f"the CUDA kernel needs {name} % 64 == 0, got {v}")
    dev = enc_t.device
    bf, f32 = torch.bfloat16, torch.float32
    want = {
        "w_comb": ((NL, 3 * W + DW, GW), bf), "b_comb": ((NL, GW), f32),
        "w_rs": ((NL, m, W + S), bf), "b_rs": ((NL, W + S), f32),
        "w_start": ((3, W), f32), "b_start": ((W,), f32),
        "w_skip0": ((W, S), bf), "b_skip0": ((S,), f32),
        "w_out1": ((S + DW, S), bf), "b_out1": ((S,), f32),
        "w_out2": ((S, out_pad), bf), "b_out2": ((out_pad,), f32),
    }
    for name, (shape, dtype) in want.items():
        _expect(name, kw[name], shape, dtype, dev)
    enc_t = enc_t.to(bf).contiguous()
    if tf is not None:
        tf = tf.to(f32).contiguous()
        _expect("tf", tf, (L, B), f32, dev)

    _, slots = ring_offsets(cfg)
    lib = _lib()
    part_floats, n_counters = ctypes.c_longlong(), ctypes.c_longlong()
    lib.fastgen_workspace(B, W, GW, DW, ctypes.byref(part_floats), ctypes.byref(n_counters))
    state = {
        "lbuf": torch.zeros((slots, B, W), dtype=bf, device=dev),
        "l": torch.zeros((B, W), device=dev),
        "l_bf": torch.zeros((B, W), dtype=bf, device=dev),
        "s": torch.zeros((B, S), device=dev),
        "gate": torch.zeros((B, m), dtype=bf, device=dev),
        "part": torch.empty((max(part_floats.value, 1),), device=dev),
        "counters": torch.zeros((n_counters.value,), dtype=torch.int32, device=dev),
        "xh": torch.zeros((3, B), device=dev),
        "audio": torch.empty((L, B), device=dev),
    }
    outp = torch.empty((L, B, out_pad), device=dev) if collect_out_params else None
    args = _FastgenArgs(
        **{name: kw[name].data_ptr() for name in want},
        enc=enc_t.data_ptr(), tf=None if tf is None else tf.data_ptr(),
        **{name: v.data_ptr() for name, v in state.items()},
        out_params=None if outp is None else outp.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        seed=int(seed), device=dev.index, B=B, L=L, W=W, GW=GW, S=S, DW=DW, NL=NL,
        num_stages=cfg.num_stages, out_pad=out_pad, out_seg=seg, head=HEADS[cfg.loss_type],
        use_mu_law=int(cfg.use_mu_law), quant_chann=cfg.quant_chann, greedy=int(greedy),
    )
    rc = lib.fastgen_generate(ctypes.byref(args))
    generate.launches += 1
    _check(lib, rc)
    audio = state["audio"].T.contiguous()
    if collect_out_params:
        return audio, outp.transpose(0, 1).contiguous()
    return audio


def generate(kw, enc_t, seed, *, greedy=False, tf=None, collect_out_params=False):
    """Generate L samples for a batch.

    kw: build_kernel_weights output; enc_t [L, B, DW] upsampled conditioning
    (already offset-trimmed, cast to bf16); seed: int; tf [L, B] f32
    teacher-forced feedback (the sample fed back after step t) or None.
    Returns audio [B, L] f32, plus out_params [B, L, out_pad] f32 with
    collect_out_params.  CUDA tensors run the CUDA kernel, CPU tensors the
    plain version.
    """
    if enc_t.device.type == "cuda":
        return _generate_cuda(kw, enc_t, seed, greedy, tf, collect_out_params)
    if enc_t.device.type == "cpu":
        return generate_plain(kw, enc_t, seed, greedy=greedy, tf=tf,
                              collect_out_params=collect_out_params)
    raise ValueError(f"unsupported device {enc_t.device}")


generate.launches = 0
