"""Whole-utterance autoregressive generation through the hand-written CUDA
kernels of ``csrc/fastgen_kernel.cu``: the port of the Pallas TPU kernel
nsynth_wavenet_tpu/ops/fastgen_kernel.py make_generate_fn in every mode it
accepts, each one-shot or streamed in chunks with carried state.

A mode is a pair (``kernel_mode``): how the residual stream enters the gate
product, and how the gate enters the res/skip product.

* act "bf16" (reference branch :561-571): bf16 ``w_comb``, f32 accumulation,
  bf16 ring rows, bf16 operands rounded at the same places.
* act "static" (weight_dtype=int8 with ``act_amax``; reference :474-475,
  :487-516, :625-626, :638-639): int8 ``w_comb`` with per-column scales, the
  residual stream quantised per layer with a calibrated scale, int8 ring
  rows, the conditioning quantised per row; the 3W part and the enc part are
  two exact int32 sums dequantised by one multiply each.
* act "row" (weight_dtype=int8 without ``act_amax``, the calibration-free
  mode; reference :229-241, :477, :517-560, :627-629, :641): the residual
  stream quantised per batch row by ``quant_log8`` with a scale 2^(e/8); a
  ring row holds the int8 payload and, in lane W, its exponent code e; enc,
  l and the two taps are FOUR int32 sums, each dequantised with its own row
  scale and added in the reference's order (enc, l, tap t-2d, tap t-d), in
  f32 or, with ``int8_combine="bf16"``, in bf16 with every product and sum
  rounded.
* rs "bf16" (``rs_dtype="bf16"``, the default under bf16 weights; reference
  :605-615): bf16 ``w_rs``, the gate rounded to bf16.
* rs "static" (int8 ``w_rs`` with ``gate_static``; reference :582-592): the
  gate quantised with the fixed scale 1/127, folded into ``s_rs``.
* rs "row" (int8 ``w_rs`` without ``gate_static``; reference :593-604): the
  f32 gate quantised per batch row by ``quant_rows_dyn``.
* streaming (reference :416-427, :737-738, :840-879), every mode: the ring
  and the three input taps come in and go out as ``state = (lbuf, xh, t0)``;
  ring phase and random counter run on the global step ``t0 + t``, so chained
  calls equal one call bit for bit.

``quant_log8`` takes its code from one 247-entry table of 2^(e/8) (e the
least code whose table entry reaches amax/127) and its multiplier from a
second table of 2^(-e/8).  Every entry is one of eight f32 values 2^(k/8)
times a whole power of two; the CUDA kernels are handed those eight and form
the same products in registers, so kernel and plain version agree on every
code and every scale whatever ``log2f`` returns in its last bit.  The reference's ceil(8*log2(.)) gives the same code except
where amax/127 lies within a rounding of a table entry.

``generate`` is the wrapper: on CUDA tensors it launches the kernel (and
raises if it cannot), on CPU tensors it runs ``generate_plain``, the plain
PyTorch version with the same signature and the same arithmetic.  Random
draws come from a Philox4x32-10 counter generator keyed by (seed, t, batch
row, lane); ``philox_uniform_plain`` implements it in torch integer ops so
kernel and plain version draw identical uniforms.  ``philox_uniform`` fills
a [rows, lanes] tensor from the same stream on the card with
philox_uniform_kernel (the counterpart of the TPU's PRNG check,
benchmarks/tpu_kernel_parity.py:141), walked as ``philox_plan`` says.

The reference's perf probes (make_generate_fn probe=, :325-331) are ported
as ``generate(probe=...)``: "cheap_gate" forms the gate from two clips,
clip(dpre[:m], 0, 1) * clip(dpre[m:], -1, 1), in place of sigmoid * tanh
(:572-577); "no_ring_write" writes no ring row, so the ring keeps what it
held when the call began (:619-633, :643-646).  Their output is wrong by
design: timed against the full call, each says what the work it drops
costs.  On the card each runs a variant of the kernels compiled into a
library of its own (kernels/build.py PROBES), counted apart in
``generate.launches_by_probe``.

On this card (H100: 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8) a step of
the full-width MoL teacher is bound by its weight stream below a batch of a
few hundred rows (bf16 67 MB, about 20 us; int8 34 MB, about 10 us, and the
int8 weights fit the 50 MB L2) and by the tensor cores above.  Every mode
runs as one persistent cooperative launch a call (plus the int8 modes'
conditioning pre-pass): the time and layer loops run on the card, with a
grid-wide barrier between dependent phases (``barriers_per_step``), and
``schedule`` cuts each phase's products over the blocks.  PERF.md has the
times.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from nsynth_wavenet_tpu_torch.kernels import build

LANE = 16  # head segments are padded to the tensor-core tile width
ROW_LANES = 16  # lanes behind the W payload bytes of a row-mode ring row; lane W holds the log8 code
LOG8_MIN, LOG8_MAX = -120, 126  # range of the log8 exponent code e, scale 2^(e/8)
HEADS = {"ce": 0, "mol": 1, "gauss": 2}
PROBES = build.PROBES["fastgen_kernel"]  # generate(probe=): "cheap_gate", "no_ring_write"

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


def _quantize_columns(w):
    """Per-output-channel symmetric int8 quantisation of [K, N] f32 ->
    (q int8, scale [1, N] f32), w ~= q * scale."""
    amax = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-8)
    scale = amax / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale.float()


def _k4(w):
    """int8 [NL, K, N] -> [NL, K/4, N, 4]: four consecutive k of a column in
    one 32-bit word, the B-operand layout of the int8 tensor-core tile."""
    nl, k, n = w.shape
    return w.reshape(nl, k // 4, 4, n).permute(0, 1, 3, 2).contiguous()


def build_kernel_weights(cfg, params, weight_dtype="bf16", rs_dtype=None, act_amax=None,
                         gate_static=False):
    """Pack the teacher's params into the kernel's layout.

    w_comb [NL, 3W+DW, GW]: dilated taps (t-2d, t-d, t) stacked over the
    mel-cond 1x1, with b_comb the sum of both biases; w_rs [NL, m, W+S];
    w_out1 [S+DW, S] with the out1 mel-cond stacked under out1; w_out2
    [S, out_pad] in the head_layout, padded logit lanes biased to -1e9.

    weight_dtype "int8": w_comb is int8 with per-column f32 scales s_comb
    [NL, 1, GW]; w_comb_k4 holds the same matrix in the CUDA kernels' layout
    (see _k4).  rs_dtype (default: weight_dtype) does the same for w_rs, s_rs
    [NL, 1, W+S] and w_rs_k4; "bf16" under int8 weights keeps the res/skip
    product in bf16 (no gate quantiser) over an int8 ring.  The head matrices
    stay bf16.  act_amax [NL] (Fastgen.calibrate_act_amax, int8 weights only)
    adds the static activation scales s_act_inv [NL] = 127/amax and s_main
    [NL, 1, GW] = amax/127 * s_comb; without it the residual stream is
    quantised per row (quant_log8) and nothing is calibrated.  gate_static
    (int8 rs only): the gate is quantised with the fixed scale 1/127, folded
    into s_rs here; without it the gate is quantised per row and s_rs stays
    the bare column scales.
    """
    if cfg.filter_length != 3:
        raise ValueError("the generation kernel needs filter_length 3")
    rs_dtype = weight_dtype if rs_dtype is None else rs_dtype
    for name, v in (("weight_dtype", weight_dtype), ("rs_dtype", rs_dtype)):
        if v not in ("bf16", "int8"):
            raise ValueError(f"{name} {v!r}: want 'bf16' or 'int8'")
    int8, int8_rs = weight_dtype == "int8", rs_dtype == "int8"
    if act_amax is not None and not int8:
        raise ValueError("act_amax (static activation scales) needs weight_dtype='int8'")
    if gate_static and not int8_rs:
        raise ValueError("gate_static needs int8 res/skip weights (weight_dtype or rs_dtype 'int8')")
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
    layers = {}
    if int8:
        q_comb, s_comb = zip(*(_quantize_columns(w) for w in w_comb))
        s_comb = torch.stack(s_comb)
        layers.update({"w_comb": torch.stack(q_comb).contiguous(), "s_comb": s_comb.contiguous()})
        layers["w_comb_k4"] = _k4(layers["w_comb"])
        if act_amax is not None:
            amax = torch.clamp(torch.as_tensor(act_amax, dtype=torch.float32, device=dev), min=1e-8)
            # tensor / tensor: a Python number over a tensor is reciprocal() * number, rounded twice
            layers["s_act_inv"] = (amax.new_tensor(127.0) / amax).contiguous()
            layers["s_main"] = ((amax / 127.0)[:, None, None] * s_comb).contiguous()
    else:
        layers["w_comb"] = torch.stack(w_comb).to(bf).contiguous()
    if int8_rs:
        q_rs, s_rs = zip(*(_quantize_columns(w) for w in w_rs))
        s_rs = torch.stack(s_rs)
        layers.update({
            "w_rs": torch.stack(q_rs).contiguous(),
            "s_rs": (s_rs * (1.0 / 127.0) if gate_static else s_rs).contiguous(),
            "gate_static": bool(gate_static),
        })
        layers["w_rs_k4"] = _k4(layers["w_rs"])
    else:
        layers["w_rs"] = torch.stack(w_rs).to(bf).contiguous()
    return {
        "cfg": cfg,
        **layers,
        "b_comb": torch.stack(b_comb).float().contiguous(),
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


def philox_round_keys(seed: int):
    """The ten round keys (k0, k1) of Philox4x32-10 under key (seed low word,
    seed high word), round 1's first: what philox_bits adds as it goes."""
    k0, k1 = seed & M32, (seed >> 32) & M32
    return tuple(((k0 + r * _PHILOX_W0) & M32, (k1 + r * _PHILOX_W1) & M32) for r in range(10))


PHILOX_THREADS = 256  # a philox_uniform_kernel block (csrc/fastgen_kernel.cu PHILOX_THREADS)


def philox_plan(rows: int, lanes: int, sms: int, blocks_per_sm: int):
    """The walk of philox_uniform_kernel, in the order the C entry takes it.
    A unit is 4 neighbouring lanes of a row, ``groups`` = ceil(lanes / 4) a
    row (the last one short when 4 does not divide ``lanes``), ``units`` =
    rows * groups in all; a grid of at most sms * blocks_per_sm blocks of
    PHILOX_THREADS threads walks them with a stride of grid * PHILOX_THREADS
    units, which is ``step_rows`` rows and ``step_groups`` units."""
    groups = -(-lanes // 4)
    units = rows * groups
    grid = max(1, min(-(-units // PHILOX_THREADS), sms * blocks_per_sm))
    step_rows, step_groups = divmod(grid * PHILOX_THREADS, groups)
    return {"lanes": lanes, "groups": groups, "units": units, "step_rows": step_rows,
            "step_groups": step_groups, "grid": grid}


_PHILOX_GRID = {}


def philox_grid_of(index: int):
    """(SMs, blocks of philox_uniform_kernel an SM holds) of card ``index``."""
    if index not in _PHILOX_GRID:
        lib, blocks = _lib(), ctypes.c_int(0)
        _check(lib, lib.philox_blocks_per_sm(index, ctypes.byref(blocks)))
        _PHILOX_GRID[index] = (torch.cuda.get_device_properties(index).multi_processor_count,
                               blocks.value)
    return _PHILOX_GRID[index]


def philox_uniform(seed: int, t: int, rows: int, lanes: int, draw: int, device="cuda"):
    """Uniforms from the kernel's own generator, [rows, lanes] at counter
    (lane, row, t, draw): launches philox_uniform_kernel for a CUDA device,
    runs philox_uniform_plain for the CPU.  Refuses, on every device, what the
    kernel's 32-bit walk and its int arguments cannot take: rows * lanes of
    2**31 or more, and a t or a draw outside [0, 2**31 - 1]."""
    if rows * lanes >= 1 << 31:
        raise ValueError(f"philox_uniform: rows {rows} x lanes {lanes} = {rows * lanes} values; "
                         f"the kernel takes fewer than 2**31")
    for name, v in (("t", t), ("draw", draw)):
        if not 0 <= v < 1 << 31:
            raise ValueError(f"philox_uniform: {name} = {v} is outside [0, 2**31 - 1]")
    device = torch.device(device)
    if device.type == "cpu":
        return philox_uniform_plain(seed, t, rows, lanes, draw, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((rows, lanes), dtype=torch.float32, device=device)
    if out.numel():
        _philox_launch(out, seed, t, draw, out.device.index)
    return out


philox_uniform.launches = 0  # philox_uniform_kernel launches


@functools.lru_cache(maxsize=64)
def _philox_words(rows, lanes, seed, index):
    """The C entry's plan and key words for a call, as ctypes arrays."""
    plan = philox_plan(rows, lanes, *philox_grid_of(index))
    keys = [k for pair in philox_round_keys(seed) for k in pair]
    return (ctypes.c_uint * len(plan))(*plan.values()), (ctypes.c_uint * len(keys))(*keys)


def _philox_launch(out, seed, t, draw, index):
    """One launch of philox_uniform_kernel that fills ``out``, a contiguous f32
    [rows, lanes] tensor on card ``index``."""
    lib = _lib()
    plan, keys = _philox_words(*out.shape, seed, index)
    rc = lib.philox_uniform(out.data_ptr(), plan, t, draw, keys, index,
                            torch.cuda.current_stream(index).cuda_stream)
    _check(lib, rc)
    philox_uniform.launches += 1


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


def _draws(cfg, seed, L, B, device, t0=0):
    """Per global step t0 <= t < t0 + L: (u1 [B, lanes], u2 [B]), made many
    steps at a time."""
    lanes = _draw_lanes(cfg)
    chunk = max(1, (1 << 20) // (B * lanes))
    for c0 in range(t0, t0 + L, chunk):
        steps = range(c0, min(c0 + chunk, t0 + L))
        u1 = philox_uniform_plain(seed, steps, B, lanes, 0, device)
        u2 = philox_uniform_plain(seed, steps, B, 1, 1, device)[..., 0]
        yield from zip(u1, u2)


@torch.no_grad()
def resample_plain(cfg, out_params, seed, *, greedy=False, t0=0):
    """The sampler alone: head outputs [B, L, out_pad] (e.g. collected from a
    kernel run that began at global step t0) -> the audio [B, L] that run
    must have drawn with this seed."""
    B, L, _ = out_params.shape
    draws = _draws(cfg, seed, L, B, out_params.device, t0)
    return torch.stack([_sample(cfg, out_params[:, t], *next(draws), greedy) for t in range(L)], 1)


def quant_rows_dyn(x):
    """Per-row symmetric int8 quantisation of [B, K] -> (q int8, r [B, 1] f32),
    x ~= q * r.  A bf16 input is abs-maxed and scaled in bf16 (the multiplier
    127/amax and the product are rounded to bf16), as the reference does; the
    product can then reach 127.5, so the clip is what keeps q inside int8."""
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True).float(), min=1e-8)
    r = amax * (1.0 / 127.0)
    # tensor / tensor: a Python number over a tensor is reciprocal() * number, rounded twice
    prod = (x * (amax.new_tensor(127.0) / amax).to(x.dtype)).float()
    return torch.clamp(torch.round(prod), -127, 127).to(torch.int8), r


ENC_MAX_WIDTH = 512  # deconv widths quant_enc_kernel takes (csrc/fastgen_kernel.cu QE_MAX_DW)


def enc_layout(enc):
    """How quant_enc_kernel reads an encoding window enc [C, B, DW] (bf16 or
    f32): "rows" when DW is contiguous (stride 1), each row starting on a
    16-byte boundary; "channels" when time is contiguous, as the deconv
    stack leaves its output ([B, T, DW] held channel by channel, so that
    ``encoding.transpose(0, 1)`` is such a window), each channel's steps
    16-byte aligned relative to one another.  Raises ValueError on a layout
    the kernel does not take (on every device, so that the plain version
    refuses what the kernel refuses): no fallback copy is made."""
    if enc.dim() != 3 or enc.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the conditioning window must be [C, B, DW] bf16 or f32, got "
                         f"{enc.dtype} {tuple(enc.shape)}")
    C, B, DW = enc.shape
    if DW % 8 or not 8 <= DW <= ENC_MAX_WIDTH:
        raise ValueError(f"quant_enc_kernel takes a deconv width that is a multiple of 8 up to "
                         f"{ENC_MAX_WIDTH}, got {DW}")
    es, (st, sb, sk) = enc.element_size(), enc.stride()
    addr = enc.data_ptr()

    def whole(stride, n):  # a stride that moves between 16-byte vectors, where it is used
        return n == 1 or stride * es % 16 == 0

    if sk == 1 and addr % 16 == 0 and whole(st, C) and whole(sb, B):
        return "rows"
    if st == 1 and addr % es == 0 and whole(sk, DW) and whole(sb, B):
        return "channels"
    raise ValueError(f"quant_enc_kernel takes a window whose rows (stride of DW 1) or channels "
                     f"(stride of time 1) are 16-byte aligned; got strides {(st, sb, sk)} of "
                     f"{es}-byte values at an address {addr % 16} bytes past a 16-byte boundary")


def enc_prepass_plain(enc):
    """Plain version of quant_enc_kernel: the window enc [C, B, DW] cast to
    bf16 and made contiguous (time-major), then quant_rows_dyn row by row.
    Returns (enc [C, B, DW] bf16, q_enc [C, B, DW] int8, r_enc [C, B] f32)."""
    enc_c = enc.to(torch.bfloat16).contiguous()
    C, B, DW = enc_c.shape
    q, r = quant_rows_dyn(enc_c.reshape(C * B, DW))
    return enc_c, q.reshape(C, B, DW), r.reshape(C, B)


def enc_prepass(enc, probe=""):
    """The int8 modes' conditioning pre-pass over an encoding window enc
    [C, B, DW] (bf16 or f32, any layout that enc_layout takes: the
    time-major view ``encoding.transpose(0, 1)[t0 : t0 + C]`` of the deconv
    output, or a contiguous time-major tensor).  One launch of
    quant_enc_kernel on a CUDA tensor (counted in
    ``generate.kernel_launches``, or with a probe in that probe's
    ``generate.launches_by_probe``, from that probe's library), the plain
    version on a CPU one.  Returns (enc [C, B, DW] bf16 contiguous, q_enc
    [C, B, DW] int8, r_enc [C, B] f32), what generate's kernel reads."""
    layout = enc_layout(enc)
    if enc.device.type == "cpu":
        return enc_prepass_plain(enc)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    C, B, DW = enc.shape
    dev = _indexed(enc.device)
    enc_c = torch.empty((C, B, DW), dtype=torch.bfloat16, device=dev)
    q = torch.empty((C, B, DW), dtype=torch.int8, device=dev)
    r = torch.empty((C, B), device=dev)
    lib = _lib(probe)
    launched = (ctypes.c_int * 1)()
    rc = lib.fastgen_quant_enc(enc.data_ptr(), int(enc.dtype == torch.float32),
                               int(layout == "channels"), *enc.stride(), C, B, DW,
                               enc_c.data_ptr(), q.data_ptr(), r.data_ptr(), dev.index,
                               torch.cuda.current_stream(dev).cuda_stream, launched)
    counts = generate.launches_by_probe[probe] if probe else generate.kernel_launches
    counts["quant_enc_kernel"] += launched[0]
    _check(lib, rc)
    return enc_c, q, r


def quant_static(x, inv):
    """f32 activations with the calibrated multiplier inv = 127/amax -> int8,
    round half to even, clipped symmetrically."""
    return torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)


def _int_mm(a, w64):
    """int8 [B, K] @ (int8 [K, N] held as f64) -> the exact integer sums as
    f32.  The sums stay below 2^53, so every f64 product and partial sum is an
    exact integer whatever the summation order; the final conversion rounds
    the same integer the CUDA kernel's int32 -> f32 conversion rounds."""
    return (a.double() @ w64).float()


_LOG8_TABLES = {}


def log8_frac():
    """2^(k/8) for k = 0..7 as f32 [8] (from f64, rounded once): what the CUDA
    kernels are handed in place of tables."""
    return torch.exp2(torch.arange(8, dtype=torch.float64) / 8).float()


def log8_tables(device):
    """(2^(e/8), 2^(-e/8)) for e = LOG8_MIN .. LOG8_MAX as f32 [247] on
    ``device``.  Every entry is log8_frac()[e mod 8] times the whole power of
    two 2^floor(e/8), an exact product: the rule by which the CUDA kernels
    compute the same values in registers (log8_pow), so that the plain version
    and the kernels take every row scale and every quantising multiplier from
    the same bits."""
    device = torch.device(device)
    if device not in _LOG8_TABLES:
        frac = log8_frac()
        tables = []
        for e in (torch.arange(LOG8_MIN, LOG8_MAX + 1), -torch.arange(LOG8_MIN, LOG8_MAX + 1)):
            tables.append((frac[e & 7] * torch.exp2((e >> 3).float())).to(device))
        _LOG8_TABLES[device] = tuple(tables)
    return _LOG8_TABLES[device]


def quant_log8(x):
    """Per-row symmetric int8 quantisation of [B, K] with the scale held to a
    power of 2^(1/8): -> (q int8, e [B, 1] int8, r [B, 1] f32), x ~= q * r,
    r = 2^(e/8).  e is the least code whose table entry reaches amax/127
    (the reference's clip(ceil(8*log2(amax/127)), -120, 126)), so |q| <= 127
    before the clip unless the row is louder than 127 * 2^15.75."""
    x = x.float()
    tab_r, tab_inv = log8_tables(x.device)
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    idx = torch.clamp(torch.searchsorted(tab_r, amax * (1.0 / 127.0)), max=tab_r.numel() - 1)
    q = torch.clamp(torch.round(x * tab_inv[idx]), -127.0, 127.0).to(torch.int8)
    return q, (idx + LOG8_MIN).to(torch.int8), tab_r[idx]


class Mode(NamedTuple):
    """How packed weights run.  act: the gate product's operands ("bf16";
    "static": int8 with calibrated per-layer scales; "row": int8 with per-row
    log8 scales whose codes ride in the ring).  rs: the res/skip product's
    ("bf16"; "static": int8 gate at the fixed scale 1/127; "row": int8 gate
    with a per-row scale)."""

    act: str
    rs: str

    @property
    def family(self):
        """Key of generate.launches_by_mode."""
        if self.act == "bf16":
            return "bf16" if self.rs == "bf16" else "bf16_rs8"
        if self.act == self.rs:
            return "w8a8" if self.act == "static" else "w8a8_row"
        return "w8a8_mixed"


def kernel_mode(kw):
    """The Mode of build_kernel_weights output, read from what it holds."""
    if kw["w_comb"].dtype == torch.int8:
        act = "static" if "s_act_inv" in kw else "row"
    else:
        act = "bf16"
    if kw["w_rs"].dtype == torch.int8:
        rs = "static" if kw["gate_static"] else "row"
    else:
        rs = "bf16"
    return Mode(act, rs)


def ring_layout(cfg, B, act):
    """(shape, dtype) of the ring lbuf in the mode's ``act`` (see init_state)."""
    _, slots = ring_offsets(cfg)
    lrow = cfg.width + (ROW_LANES if act == "row" else 0)
    return (slots, B, lrow), torch.bfloat16 if act == "bf16" else torch.int8


def init_state(cfg, B, device, act="bf16"):
    """Fresh streaming state (lbuf, xh, t0 = 0): xh [3, B] f32 zeros and the
    ring lbuf [sum 2d, B, lrow] zeros in the ring type of the mode's ``act``:
    bf16 rows of W for "bf16", int8 rows of W for "static", and for "row"
    int8 rows of W + ROW_LANES: W payload bytes, then the row's log8 exponent
    code in lane W (the other lanes stay zero; they keep a row a whole number
    of 16-byte vectors).  A zero row reads as payload 0 at scale 2^0."""
    shape, ring = ring_layout(cfg, B, act)
    return torch.zeros(shape, dtype=ring, device=device), torch.zeros((3, B), device=device), 0


def check_probe(probe, allow_wrong_output):
    """Refuse an unknown probe, and a probe without allow_wrong_output=True."""
    if probe not in ("",) + PROBES:
        raise ValueError(f"unknown probe {probe!r}: want '' or one of {PROBES}")
    if probe and not allow_wrong_output:
        raise ValueError(f"probe {probe!r} produces WRONG output by design (perf attribution "
                         "only); pass allow_wrong_output=True to confirm this is not a serving call")


@torch.no_grad()
def generate_plain(kw, enc_t, seed, *, greedy=False, tf=None, collect_out_params=False,
                   state=None, return_state=False, int8_combine="f32", probe="",
                   allow_wrong_output=False):
    """Plain PyTorch version of the kernels, every mode (see ``generate``)."""
    check_probe(probe, allow_wrong_output)
    if int8_combine not in ("f32", "bf16"):
        raise ValueError(f"int8_combine {int8_combine!r}: want 'f32' or 'bf16'")
    cfg = kw["cfg"]
    L, B, _ = enc_t.shape
    dev = enc_t.device
    W, S = cfg.width, cfg.skip_width
    m = cfg.gate_width // 2
    half = float(cfg.quant_chann // 2)
    dils = dilations(cfg)
    offs, _ = ring_offsets(cfg)
    mode = kernel_mode(kw)
    f32 = {k: v.float() for k, v in kw.items()
           if isinstance(v, torch.Tensor) and v.dtype != torch.int8}
    w_start = f32["w_start"]
    if mode.act != "bf16":
        w_comb64, s_comb = kw["w_comb"].double(), f32["s_comb"][:, 0]
    if mode.act == "static":
        s_main, s_act_inv = f32["s_main"][:, 0], f32["s_act_inv"]
    if mode.act == "row":
        tab_r, _ = log8_tables(dev)
        # the combine's type: every product and sum below rounds to it
        cdt = torch.bfloat16 if int8_combine == "bf16" else torch.float32
        s_comb_c, b_comb_c = s_comb.to(cdt), f32["b_comb"].to(cdt)
    if mode.rs != "bf16":
        w_rs64, s_rs = kw["w_rs"].double(), f32["s_rs"][:, 0]

    enc_bf = enc_t.to(torch.bfloat16)
    enc_t = enc_bf.float()
    lbuf, xh, t0 = init_state(cfg, B, dev, mode.act) if state is None else state
    audio = torch.empty((L, B), device=dev)
    outp = torch.empty((L, B, f32["w_out2"].shape[1]), device=dev) if collect_out_params else None
    draws = _draws(cfg, seed, L, B, dev, t0)
    for t in range(L):
        tg = t0 + t  # global step: ring phase (and, in _draws, the random counter)
        enc = enc_t[t]
        l = (xh[0][:, None] * w_start[0] + xh[1][:, None] * w_start[1]
             + xh[2][:, None] * w_start[2] + f32["b_start"])
        s = _bf(l) @ f32["w_skip0"] + f32["b_skip0"]
        if mode.act != "bf16":
            q_enc, r_enc = quant_rows_dyn(enc_bf[t])
        if mode.act == "static":
            q_l = quant_static(l, s_act_inv[0])
        elif mode.act == "row":
            q_l, e_l, r_l = quant_log8(l)
        for li, d in enumerate(dils):
            r2 = offs[li] + tg % (2 * d)
            r1 = offs[li] + (tg + d) % (2 * d)
            if mode.act == "static":
                mm = _int_mm(torch.cat([lbuf[r2], lbuf[r1], q_l], 1), w_comb64[li, : 3 * W])
                acc_enc = _int_mm(q_enc, w_comb64[li, 3 * W :]) * r_enc
                dpre = mm * s_main[li] + acc_enc * s_comb[li] + f32["b_comb"][li]
            elif mode.act == "row":
                # four exact sums, each with its own row scale, added in the
                # reference's order: enc, l, tap t-2d, tap t-d
                acc = _int_mm(q_enc, w_comb64[li, 3 * W :]).to(cdt) * r_enc.to(cdt)
                acc = acc + _int_mm(q_l, w_comb64[li, 2 * W : 3 * W]).to(cdt) * r_l.to(cdt)
                for j, row in enumerate((r2, r1)):
                    r_t = tab_r[lbuf[row, :, W].long() - LOG8_MIN][:, None]
                    acc = acc + (_int_mm(lbuf[row, :, :W], w_comb64[li, j * W : (j + 1) * W]).to(cdt)
                                 * r_t.to(cdt))
                dpre = (acc * s_comb_c[li] + b_comb_c[li]).float()
            else:
                stack = torch.cat([lbuf[r2].float(), lbuf[r1].float(), _bf(l), enc], 1)
                dpre = stack @ f32["w_comb"][li] + f32["b_comb"][li]
            if probe == "cheap_gate":
                gate = torch.clamp(dpre[:, :m], 0.0, 1.0) * torch.clamp(dpre[:, m:], -1.0, 1.0)
            else:
                gate = torch.sigmoid(dpre[:, :m]) * torch.tanh(dpre[:, m:])
            if mode.rs == "static":
                # |gate| < 1, so round(gate * 127) stays inside int8 without a clip
                q_gate = torch.round(gate * 127.0).to(torch.int8)
                rs = _int_mm(q_gate, w_rs64[li]) * s_rs[li] + f32["b_rs"][li]
            elif mode.rs == "row":
                q_gate, r_gate = quant_rows_dyn(gate)
                rs = _int_mm(q_gate, w_rs64[li]) * (r_gate * s_rs[li]) + f32["b_rs"][li]
            else:
                rs = _bf(gate) @ f32["w_rs"][li] + f32["b_rs"][li]
            # the ring of layer li holds the layer's input as the gate product read it
            # (no_ring_write: what it held when the call began)
            if probe != "no_ring_write":
                if mode.act == "static":
                    lbuf[r2] = q_l
                elif mode.act == "row":
                    lbuf[r2, :, :W] = q_l
                    lbuf[r2, :, W] = e_l[:, 0]
                else:
                    lbuf[r2] = l.to(torch.bfloat16)
            l = l + rs[:, :W]
            s = s + rs[:, W:]
            if li + 1 < len(dils):
                if mode.act == "static":
                    q_l = quant_static(l, s_act_inv[li + 1])
                elif mode.act == "row":
                    q_l, e_l, r_l = quant_log8(l)
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
    result = [audio.T.contiguous()]
    if collect_out_params:
        result.append(outp.transpose(0, 1).contiguous())
    if return_state:
        result.append((lbuf, xh, t0 + L))
    return result[0] if len(result) == 1 else tuple(result)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# work table of the persistent kernel
# ---------------------------------------------------------------------------

# layout constants of csrc/fastgen_kernel.cu (THREADS, TM, KC, BN, AS_LD, HDR, ITEM)
THREADS, TILE_ROWS, KC, BN, AS_LD, HDR, ITEM = 256, 128, 64, 16, 80, 16, 6
RS_COLS = 32  # columns of a res/skip item (RC)
GATE_COLS = 32  # sigmoid columns of a gate item, and as many tanh columns (GC)
OPERAND_SLOTS = 4  # operand chunks of 128 rows x 128 bytes in flight (NS)
GATE_CONST_BYTES = 6 * 32 * 4  # a gate item's bias and scale columns behind its weights (CST_WORDS)
TABLE_WORDS = 4096  # most words of a work table (it sits in every block's shared memory)
GATE_SLICE_BYTES = 512  # operand bytes a batch row of a gate item: k span 256 in bf16
MAX_ROW_GROUPS = 4  # row groups of a res/skip, out1 or out2 column item
SMEM_LIMIT = 232448  # shared memory a block may use on an H100 (227 KB)
PHASES = ("gate", "skip0", "rs", "out1", "out2")  # item order in the table


class Schedule(NamedTuple):
    """How the persistent kernel cuts one step's products (``schedule``)."""

    items: dict        # phase -> [(column item, k_begin, k_end, slice, first row tile, end row tile)]
    segments: list     # gate product: [(k_begin, k_end)] of the sums that dequantise apart
    slice_segment: list  # gate slice z -> its segment
    table: list        # int32 words handed to the kernel
    stage_bytes: int   # one weight stage in shared memory
    slot_bytes: int    # one operand chunk slot
    smem_bytes: int    # dynamic shared memory of a block
    row_tiles: int     # 128-row tiles of the batch
    part_words: int    # 32-bit words of the gate's split-K partial tiles
    counters: int      # arrival counts, one per (gate column item, row tile)


def gate_spans(W, DW, act):
    """Most k of a gate item in each of gate_segments: GATE_SLICE_BYTES of
    operand a row, so that the items of a phase stream alike.  bf16: 256
    everywhere.  The per-row mode reads l as f32 (128) and its int8 taps and
    enc at 512; the static mode's int8 segments stay at 256, so that its
    items are as many as bf16's (and each streams half the bytes)."""
    if act == "row":
        return [GATE_SLICE_BYTES, GATE_SLICE_BYTES, GATE_SLICE_BYTES // 4, GATE_SLICE_BYTES]
    return [GATE_SLICE_BYTES // 2] * len(gate_segments(W, DW, act))


def gate_segments(W, DW, act):
    """K ranges of the gate product [tap t-2d | tap t-d | l | enc] whose sums
    are dequantised apart: none in bf16, the 3W part and enc with static
    scales, all four with per-row scales."""
    K = 3 * W + DW
    if act == "bf16":
        return [(0, K)]
    if act == "static":
        return [(0, 3 * W), (3 * W, K)]
    return [(0, W), (W, 2 * W), (2 * W, 3 * W), (3 * W, K)]


def schedule(W, GW, S, DW, out_pad, B, act="bf16", rs="bf16", grid=None):
    """The persistent kernel's work table for one batch B in mode (act, rs)
    on ``grid`` blocks (None: as if one block per item).

    Every product of a step is cut into items by its weight columns:
    GATE_COLS sigmoid + as many tanh columns of w_comb, RS_COLS of w_rs,
    16 of w_skip0, w_out1 and w_out2.  The gate product is also cut along K
    into slices (at most gate_spans, and in bf16 finer while a batch of one
    row tile would leave half the grid idle) that never straddle two
    segments (gate_segments).  A skip_start item walks all B rows in 128-row tiles,
    and so does every other item where that keeps the blocks busy, so that
    each weight byte is read by one block a step.  Where blocks would idle,
    the rows are cut into up to MAX_ROW_GROUPS groups of whole tiles, one
    item each: a weight slice (8-36 KB) is then read by as many blocks, and
    each block streams a share of the batch rows, which at a large batch
    outweigh the weights many times.  The slices of a gate column item and
    row group are consecutive items.  Item j of a phase runs on block j mod
    grid.  ``table`` is what the kernel reads: a
    header of HDR ints (gate items, slices, skip_start, res/skip, out1, out2
    items, offset of the slices' segments), ITEM ints an item (column item,
    k_begin, k_end, slice, first row tile, end row tile) in PHASES order, then
    the segment of each gate slice."""
    m, N, K = GW // 2, W + S, 3 * W + DW
    n_rt = -(-B // TILE_ROWS)

    def groups(n_items):  # row-tile ranges of a column item (and slice)
        r = 1 if grid is None else max(1, min(n_rt, grid // n_items, MAX_ROW_GROUPS))
        cut = [n_rt * i // r for i in range(r + 1)]
        return list(zip(cut, cut[1:]))

    segs = gate_segments(W, DW, act)

    def cut(spans):
        return [(k, min(k + span, k1), si) for si, ((k0, k1), span) in enumerate(zip(segs, spans))
                for k in range(k0, k1, span)]

    spans = gate_spans(W, DW, act)
    slices = cut(spans)
    # one row tile leaves most blocks idle: a bf16 gate (twice the operand bytes of
    # an int8 one) is then cut finer along K, which takes 5 % off the bf16 call
    # at B = 64 (ab_fastgen.py against the tree without it, PERF.md section 6)
    while (act == "bf16" and grid is not None and n_rt == 1
           and m // GATE_COLS * len(slices) < grid // 2 and min(spans) >= 2 * KC):
        spans = [span // 2 for span in spans]
        slices = cut(spans)
    items = {
        "gate": [(ct, k0, k1, z, r0, r1) for ct in range(m // GATE_COLS)
                 for r0, r1 in groups(m // GATE_COLS * len(slices)) for z, (k0, k1, _) in enumerate(slices)],
        "skip0": [(ct, 0, W, 0, 0, n_rt) for ct in range(S // BN)],
        "rs": [(ct, 0, m, 0, r0, r1) for ct in range(N // RS_COLS) for r0, r1 in groups(N // RS_COLS)],
        "out1": [(ct, 0, S + DW, 0, r0, r1) for ct in range(S // BN) for r0, r1 in groups(S // BN)],
        "out2": [(ct, 0, S, 0, r0, r1) for ct in range(out_pad // BN)
                 for r0, r1 in groups(out_pad // BN)],
    }
    flat = [w for ph in PHASES for it in items[ph] for w in it]
    seg_of = [si for _, _, si in slices]
    header = [len(items["gate"]), len(slices), len(items["skip0"]), len(items["rs"]),
              len(items["out1"]), len(items["out2"]), HDR + len(flat)]
    table = header + [0] * (HDR - len(header)) + flat + seg_of
    table += [0] * (-len(table) % 4)
    if len(table) > TABLE_WORDS:
        raise ValueError(f"the work table has {len(table)} words, more than {TABLE_WORDS}")

    def stage(rows, ng, word_bytes):  # rows of ng 16-column groups, padded by 8
        return rows * (ng * BN + 8) * word_bytes

    span, gng = max(k1 - k0 for k0, k1, _ in slices), GATE_COLS // 8
    gate_stage = (stage(span, gng, 2) if act == "bf16" else stage(span // 4, gng, 4)) + GATE_CONST_BYTES
    rs_stage = stage(m, RS_COLS // BN, 2) if rs == "bf16" else stage(m // 4, RS_COLS // BN, 4)
    stage_bytes = _round_up(max(gate_stage, rs_stage, stage(W, 1, 2), stage(S + DW, 1, 2),
                                stage(S, 1, 2)), 128)
    slot_bytes = TILE_ROWS * (KC * 2 + 16)
    # the layout of fastgen_persistent: two weight stages, the operand slots,
    # the quantised operand tile, the product tile, two [B] f32 row arrays in
    # each per-row mode (the l codes and multipliers; the gate's scales and
    # multipliers), the table
    row_arrays = 2 * (act == "row") + 2 * (rs == "row")
    smem = (2 * stage_bytes + OPERAND_SLOTS * slot_bytes + TILE_ROWS * AS_LD
            + TILE_ROWS * (2 * GATE_COLS + 4) * 4 + 4 * row_arrays * B + 4 * len(table))
    return Schedule(items, segs, seg_of, table, stage_bytes, slot_bytes, smem, n_rt,
                    (m // GATE_COLS) * n_rt * len(slices) * TILE_ROWS * 2 * GATE_COLS, (m // GATE_COLS) * n_rt)


def barriers_per_step(cfg):
    """Grid barriers of one step: a gate and a res/skip phase per layer, out1,
    out2, and sample + start."""
    return 2 * cfg.num_layers + 3


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


class _FastgenArgs(ctypes.Structure):
    """Mirror of struct FastgenArgs in csrc/fastgen_kernel.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_comb", "b_comb", "w_rs", "b_rs", "s_comb", "s_main", "s_rs", "s_act_inv",
        "w_start", "b_start", "w_skip0", "b_skip0",
        "w_out1", "b_out1", "w_out2", "b_out2", "enc", "tf", "lbuf", "xh", "l", "l_bf", "q_l",
        "q_enc", "r_enc", "lmax", "gmax", "s", "s_bf", "o1", "outv", "gate", "part", "counters",
        "table", "bar", "audio", "out_params", "stream",
    )] + [("seed", ctypes.c_longlong)] + [(name, ctypes.c_int) for name in (
        "device", "B", "L", "W", "GW", "S", "DW", "NL", "num_stages",
        "out_pad", "out_seg", "head", "use_mu_law", "quant_chann", "greedy", "t0",
        "act_mode", "rs_mode", "combine_bf16",
    )] + [("log8_frac", ctypes.c_float * 8)] + [(name, ctypes.c_int) for name in (
        "grid", "stage_bytes", "slot_bytes", "smem_bytes", "table_words",
    )]


_MODE_CODES = {"bf16": 0, "static": 1, "row": 2}  # ActMode / RsMode in csrc/fastgen_kernel.cuh
# generate's CUDA kernels: fastgen_generate's launched[0], fastgen_quant_enc's launched[0]
KERNEL_NAMES = ("fastgen_persistent", "quant_enc_kernel")


def _lib(probe=""):
    """The serving library, or with a probe the library of its variants."""
    lib = build.load(build.library_of("fastgen_kernel", probe))
    if not getattr(lib, "_argtypes_set", False):
        lib.fastgen_generate.argtypes = [ctypes.POINTER(_FastgenArgs), ctypes.POINTER(ctypes.c_int)]
        lib.fastgen_generate.restype = ctypes.c_int
        lib.fastgen_grid.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.fastgen_grid.restype = ctypes.c_int
        lib.fastgen_barrier_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_void_p]
        lib.fastgen_barrier_probe.restype = ctypes.c_int
        lib.philox_uniform.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.philox_uniform.restype = ctypes.c_int
        lib.philox_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.philox_blocks_per_sm.restype = ctypes.c_int
        lib.fastgen_quant_enc.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.fastgen_quant_enc.restype = ctypes.c_int
        lib.fastgen_error_string.argtypes = [ctypes.c_int]
        lib.fastgen_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, rc):
    if rc != 0:
        msg = lib.fastgen_error_string(rc).decode()
        raise RuntimeError(f"CUDA generation kernel failed: {msg} (cudaError {rc})")


_GRID = {}


def _indexed(device):
    """torch.device with its index ("cuda" alone means the current card)."""
    device = torch.device(device)
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def launch_info(mode, smem_bytes, device, probe=""):
    """What the card makes of the persistent kernel of ``mode`` (in
    ``probe``'s variant) with ``smem_bytes`` of dynamic shared memory: {grid,
    blocks_per_sm, sms, registers, spill_bytes (local memory a thread),
    static_smem, smem_limit}.  grid is the cooperative launch's: every block
    that fits at once."""
    device = _indexed(device)
    key = (mode, smem_bytes, device.index, probe)
    if key not in _GRID:
        lib = _lib(probe)
        info = (ctypes.c_int * 6)()
        _check(lib, lib.fastgen_grid(_MODE_CODES[mode.act], _MODE_CODES[mode.rs], smem_bytes,
                                     device.index, info))
        per_sm, sms, regs, spill, static, limit = list(info)
        if per_sm < 1:
            raise RuntimeError(f"the persistent generation kernel does not fit an SM with "
                               f"{smem_bytes} bytes of shared memory")
        _GRID[key] = {"grid": per_sm * sms, "blocks_per_sm": per_sm, "sms": sms, "registers": regs,
                      "spill_bytes": spill, "static_smem": static, "smem_limit": limit}
    return dict(_GRID[key])


def barrier_probe(grid, iters, device="cuda"):
    """Launch ``iters`` empty grid barriers on ``grid`` blocks (one cooperative
    launch, the generation kernel's barrier); for timing one barrier."""
    device = _indexed(device)
    bar = torch.zeros((2,), dtype=torch.int64, device=device)
    lib = _lib()
    _check(lib, lib.fastgen_barrier_probe(grid, iters, bar.data_ptr(), device.index,
                                          torch.cuda.current_stream(device).cuda_stream))


def _expect(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{name} must be contiguous and 32-byte aligned")


def launch_plan(W, GW, S, DW, out_pad, B, mode, device, probe=""):
    """The work table and the launch of one call at batch B: (schedule,
    launch_info).  The table is cut for the grid it runs on (its row groups
    and K slices depend on the grid) and its shared memory depends on the
    table, so the grid starts at the blocks that fit by registers and
    threads alone and shrinks until every block of its own table fits at
    once; the shared memory checked against SMEM_LIMIT is the launched one.
    ``probe``: plan the launch of that probe's variant."""
    info_of = functools.partial(launch_info, probe=probe) if probe else launch_info
    grid = info_of(mode, 0, device)["grid"]
    while True:
        sched = schedule(W, GW, S, DW, out_pad, B, mode.act, mode.rs, grid=grid)
        if sched.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"batch {B}: the {mode.act}/{mode.rs} kernel needs {sched.smem_bytes} "
                             f"bytes of shared memory a block, more than {SMEM_LIMIT} (each per-row "
                             f"mode keeps two [B] f32 arrays there)")
        info = info_of(mode, sched.smem_bytes, device)
        if info["grid"] >= grid:
            info["grid"] = grid
            return sched, info
        grid = info["grid"]


def barriers_counted():
    """Grid barriers a step of the last CUDA generate call, as the kernel
    counted them: the count its barriers ended at, over grid x steps (a
    synchronising read)."""
    bar, grid, L = generate.last_barrier_count
    return int(bar[0].item()) / (grid * L)


def _generate_cuda(kw, enc_t, seed, greedy, tf, collect_out_params, state, return_state,
                   int8_combine, probe):
    cfg = kw["cfg"]
    L, B, DW = enc_t.shape
    W, GW, S, NL = cfg.width, cfg.gate_width, cfg.skip_width, cfg.num_layers
    m = GW // 2
    seg, out_pad = head_layout(cfg)
    mode = kernel_mode(kw)
    if int8_combine not in ("f32", "bf16"):
        raise ValueError(f"int8_combine {int8_combine!r}: want 'f32' or 'bf16'")
    if DW != cfg.deconv_width:
        raise ValueError(f"enc_t width {DW} != deconv_width {cfg.deconv_width}")
    # % 64: whole K chunks and column items; it also gives the int8 rows (W, DW
    # and m bytes) the 16-byte alignment of the kernel's asynchronous copies
    for name, v in (("width", W), ("skip_width", S), ("deconv_width", DW), ("gate_width/2", m)):
        if v % 64:
            raise ValueError(f"the CUDA kernel needs {name} % 64 == 0, got {v}")
    dev = enc_t.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    K, N = 3 * W + DW, W + S
    want = {
        "b_comb": ((NL, GW), f32), "b_rs": ((NL, N), f32),
        "w_start": ((3, W), f32), "b_start": ((W,), f32),
        "w_skip0": ((W, S), bf), "b_skip0": ((S,), f32),
        "w_out1": ((S + DW, S), bf), "b_out1": ((S,), f32),
        "w_out2": ((S, out_pad), bf), "b_out2": ((out_pad,), f32),
    }
    # the int8 kernels read the k4 copies; w_comb and w_rs are then the plain version's
    if mode.act == "bf16":
        want["w_comb"] = ((NL, K, GW), bf)
    else:
        want.update({"w_comb_k4": ((NL, K // 4, GW, 4), i8), "s_comb": ((NL, 1, GW), f32)})
    if mode.act == "static":
        want.update({"s_main": ((NL, 1, GW), f32), "s_act_inv": ((NL,), f32)})
    if mode.rs == "bf16":
        want["w_rs"] = ((NL, m, N), bf)
    else:
        want.update({"w_rs_k4": ((NL, m // 4, N, 4), i8), "s_rs": ((NL, 1, N), f32)})
    for name, (shape, dtype) in want.items():
        _expect(name, kw[name], shape, dtype, dev)
    if mode.act == "bf16":  # the bf16 mode's own pre-pass: a PyTorch copy of the window
        enc_c = enc_t.to(bf).contiguous()
        _expect("enc_t", enc_c, (L, B, DW), bf, dev)
    if tf is not None:
        tf = tf.to(f32).contiguous()
        _expect("tf", tf, (L, B), f32, dev)

    lbuf, xh, t0 = init_state(cfg, B, dev, mode.act) if state is None else state
    _expect("state lbuf", lbuf, *ring_layout(cfg, B, mode.act), dev)
    _expect("state xh", xh, (3, B), f32, dev)
    t0 = int(t0)
    if not 0 <= t0 <= 2**31 - 1 - L:
        raise ValueError(f"state t0 {t0} + {L} steps leaves the 32-bit step counter")

    sched, info = launch_plan(W, GW, S, DW, out_pad, B, mode, dev, probe)
    lib = _lib(probe)
    scratch = {
        "l": torch.empty((B, W), device=dev),
        "l_bf": torch.empty((B, W), dtype=bf, device=dev),
        "s": torch.empty((B, S), device=dev),
        "s_bf": torch.empty((B, S), dtype=bf, device=dev),
        "o1": torch.empty((B, S), dtype=bf, device=dev),
        "outv": torch.empty((B, out_pad), device=dev),
        "gate": torch.empty((B, m), dtype={"bf16": bf, "static": i8, "row": f32}[mode.rs], device=dev),
        "part": torch.empty((max(sched.part_words, 1),),
                            dtype=f32 if mode.act == "bf16" else torch.int32, device=dev),
        "counters": torch.zeros((sched.counters,), dtype=torch.int32, device=dev),
        "table": torch.tensor(sched.table, dtype=torch.int32).to(dev),
        "bar": torch.zeros((2,), dtype=torch.int64, device=dev),
        "audio": torch.empty((L, B), device=dev),
    }
    if mode.act == "static":
        scratch["q_l"] = torch.empty((B, W), dtype=i8, device=dev)
    # per-layer row maxima, one slot per producer column item; rewritten in every step
    if mode.act == "row":
        scratch["lmax"] = torch.zeros((NL, W // RS_COLS, B), device=dev)
    if mode.rs == "row":
        scratch["gmax"] = torch.zeros((NL, m // GATE_COLS, B), device=dev)
    outp = torch.empty((L, B, out_pad), device=dev) if collect_out_params else None
    weights = {name.removesuffix("_k4"): kw[name].data_ptr() for name in want}
    if mode.act != "bf16":  # quant_enc_kernel reads the window as it lies
        enc_c, scratch["q_enc"], scratch["r_enc"] = enc_prepass(enc_t, probe)
    args = _FastgenArgs(
        **weights, enc=enc_c.data_ptr(), tf=None if tf is None else tf.data_ptr(),
        lbuf=lbuf.data_ptr(), xh=xh.data_ptr(),
        **{name: v.data_ptr() for name, v in scratch.items()},
        out_params=None if outp is None else outp.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        seed=int(seed), device=dev.index, B=B, L=L, W=W, GW=GW, S=S, DW=DW, NL=NL,
        num_stages=cfg.num_stages, out_pad=out_pad, out_seg=seg, head=HEADS[cfg.loss_type],
        use_mu_law=int(cfg.use_mu_law), quant_chann=cfg.quant_chann, greedy=int(greedy),
        t0=t0, act_mode=_MODE_CODES[mode.act], rs_mode=_MODE_CODES[mode.rs],
        combine_bf16=int(int8_combine == "bf16"),
        log8_frac=(ctypes.c_float * 8)(*log8_frac().tolist()),
        grid=info["grid"], stage_bytes=sched.stage_bytes, slot_bytes=sched.slot_bytes,
        smem_bytes=sched.smem_bytes, table_words=len(sched.table),
    )
    launched = (ctypes.c_int * 1)()
    rc = lib.fastgen_generate(ctypes.byref(args), launched)
    if probe:  # apart from the serving counts, which no probe call may meet
        counts = generate.launches_by_probe[probe]
    else:
        generate.launches += 1
        by_mode = generate.launches_by_mode
        by_mode[mode.family] = by_mode.get(mode.family, 0) + 1
        counts = generate.kernel_launches
    counts["fastgen_persistent"] += launched[0]
    generate.last_barrier_count = (scratch["bar"], info["grid"], L)
    _check(lib, rc)
    result = [scratch["audio"].T.contiguous()]
    if collect_out_params:
        result.append(outp.transpose(0, 1).contiguous())
    if return_state:
        result.append((lbuf, xh, t0 + L))
    return result[0] if len(result) == 1 else tuple(result)


def generate(kw, enc_t, seed, *, greedy=False, tf=None, collect_out_params=False,
             state=None, return_state=False, int8_combine="f32", probe="",
             allow_wrong_output=False):
    """Generate L samples for a batch.

    kw: build_kernel_weights output; what it holds decides the mode
    (kernel_mode): bf16 or int8 ``w_comb`` (int8 with static scales, or with
    per-row log8 scales when it was packed without act_amax), bf16 or int8
    ``w_rs`` (int8 with the fixed or a per-row gate scale).  enc_t [L, B, DW]
    upsampled conditioning, already offset-trimmed: a contiguous time-major
    tensor, or the window ``encoding.transpose(0, 1)[t0 : t0 + L]`` of the
    deconv's output as it lies.  The bf16 mode copies it to a contiguous bf16
    tensor (any layout); the int8 modes hand it to enc_prepass, which takes
    bf16 or f32 in a layout of enc_layout and raises on any other, on every
    device, with no fallback copy.  seed: int;
    tf [L, B] f32 teacher-forced feedback (the sample fed back after step t)
    or None.  int8_combine "bf16" (read by the per-row activation mode only):
    the four dequantised sums of a layer are combined in bf16, every product
    and sum rounded, instead of f32.
    state: (lbuf, xh, t0) from a previous call with return_state (None: a
    fresh utterance, see init_state for the ring's layout in each mode).  The
    state passed in is consumed: its buffers are updated in place and come
    back in the new state.
    Returns audio [B, L] f32, then out_params [B, L, out_pad] f32 with
    collect_out_params, then the new state with return_state.  CUDA tensors
    run the CUDA kernels, CPU tensors the plain version.
    probe (PERF ATTRIBUTION ONLY, the output is wrong): "cheap_gate" forms
    the gate as clip(dpre[:m], 0, 1) * clip(dpre[m:], -1, 1), in f32 in every
    mode (with int8_combine="bf16" the reference clips and multiplies in its
    bf16 combine's type; the port's gate is f32 in every mode); "no_ring_write"
    writes no ring row, so the ring, and with return_state the lbuf that
    comes back, hold what they held when the call began.  Everything else
    runs as in the full call.  A probe needs allow_wrong_output=True, on
    every device.  That guard is the one deliberate difference from the
    reference's make_generate_fn, whose AR probes have none; its flow
    kernel's have (nsynth_wavenet_tpu/ops/flow_kernel.py:155-159).
    """
    check_probe(probe, allow_wrong_output)
    if kernel_mode(kw).act != "bf16":
        enc_layout(enc_t)
    if enc_t.device.type == "cuda":
        return _generate_cuda(kw, enc_t, seed, greedy, tf, collect_out_params, state, return_state,
                              int8_combine, probe)
    if enc_t.device.type == "cpu":
        return generate_plain(kw, enc_t, seed, greedy=greedy, tf=tf,
                              collect_out_params=collect_out_params, state=state,
                              return_state=return_state, int8_combine=int8_combine, probe=probe,
                              allow_wrong_output=allow_wrong_output)
    raise ValueError(f"unsupported device {enc_t.device}")


generate.launches = 0
# by CUDA kernel, counted where csrc/fastgen_kernel.cu fastgen_generate enqueues each launch
generate.kernel_launches = dict.fromkeys(KERNEL_NAMES, 0)
generate.last_barrier_count = None  # (barrier count on the card, grid, steps) of the last CUDA call
# by Mode.family: "bf16", "w8a8" (static + static), "w8a8_row" (row + row), "w8a8_mixed", "bf16_rs8"
generate.launches_by_mode = {"bf16": 0, "w8a8": 0, "w8a8_row": 0}
# a probe call's CUDA launches, by probe and kernel; a probe call adds to no count above
generate.launches_by_probe = {probe: dict.fromkeys(KERNEL_NAMES, 0) for probe in PROBES}
