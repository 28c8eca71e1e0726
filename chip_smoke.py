"""Drive the PyTorch / CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them.  Phases, each fatal on failure:
  1. device, nvidia-smi name and power limit, kernel build (timed);
  2. the CUDA generation kernel against its plain PyTorch version at the full
     width of configs/wavenet_mol.json (30 layers, width 512), random weights
     from a seed, B = 8, L = 256: teacher-forced greedy head outputs, and a
     sampled free run replayed through the plain sampler and the plain network;
  3. the same checks for the CE (mu-law, double gate) and Gauss heads at 4 layers,
     and for the trained tiny MoL golden;
  4. the kernel's Philox generator against the plain one, and its statistics;
  5. the main path end to end at full width, B = 64 and 512, L = 2000:
     numpy wavs -> mel -> deconv on the card -> Fastgen.generate_cuda, sampled;
     kernel launch counts; the phase 2 checks again at B = 64 and 512,
     L = 48; step time, and per-kernel timings against the plain version,
     cuBLAS and the card's bound;
  6. evaluation.generate_wavenet over two wavs with the golden tiny_mol weights;
  7. a golden free run that must track its conditioning;
  8. the CUDA flow-stack kernel against its plain PyTorch version at the full
     width of configs/parallel_wavenet.json (10 layers, dilations 1..512, width
     64, deconv width 256), random weights from a seed: one-shot at B = 8 x
     L = 8192, B = 32 x L = 4096 and B = 3 x L = 1000 (ragged last tile);
     chained chunks of 2048 and of 512 (shorter than the largest 2d) equal to
     the one-shot call bit for bit, and their final state against the plain one;
  9. the student path end to end at full width (60 layers in 4 flows), B = 32
     and 8, 4 s of audio: numpy wavs -> mel -> shared deconv on the card ->
     parallelgen.synthesize_cuda; kernel launch counts; the fused feed-forward
     against the same path on the plain kernel; StudentStreamer (chunk 32768)
     against the one-shot path on the same noise; the stack call at the path's
     own B = 32 x L = 64000 against its plain version for every cycle offset,
     and timed against it, torch.mm on the same products and the card's bound;
     device time per CUDA kernel;
 10. the trained golden tiny_student on the card: fused against plain audio,
     streamer against one-shot, and a free synthesis that tracks its mels;
 11. evaluation.generate_parallel_wavenet over two wavs, one-shot and streamed.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import generate_parallel_wavenet, generate_wavenet
from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk
from nsynth_wavenet_tpu_torch.ops import stft

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
MAIN_BATCHES = (64, 512)
MAIN_LENGTH = 2000
TIMED_STEPS = 128
CHECK_STEPS = 48  # kernel-vs-plain length at the main path's batches
# kernel vs plain, head outputs within REL_TOL * max(|plain|, 1): the JAX
# kernel test's tolerance, held by the 4-layer heads and the trained golden.
REL_TOL = 5e-3
# At full width with random N(0, 0.05) weights the 30-layer network
# amplifies f32 summation-order and bf16 rounding differences: the plain
# version on the CPU and on the card part by 1.28e-2 to 1.48e-2 x scale over
# 256 steps, and the kernel from the plain version on the card by 4e-3 x
# scale in the first step alone and 1.35e-2 to 1.50e-2 x scale over 256
# steps (this script, three runs on an H100 80GB HBM3 at 700 W), so no
# implementation can meet REL_TOL there.  This fixed limit sits 1.7x above
# the largest of those readings; PERF.md gives them.
FULL_WIDTH_REL_TOL = 2.5e-2
# flow kernel vs plain, stream within FLOW_REL_TOL * max(|plain|, 1): the same
# roundings in another summation order over 10 layers.  PERF.md gives the
# readings it was set from and the plain version's own CPU-vs-card distance.
FLOW_REL_TOL = 5e-3
# the fused feed-forward on the kernel vs on the plain kernel, 60 layers in 4
# flows, every key of the ff dict within this share of max(|plain|, 1e-3)
STUDENT_REL_TOL = 2e-2
STUDENT_BATCHES = (32, 8)
STUDENT_SAMPLES = 64000  # 4 s


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def require(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps=3):
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def full_model(path, seed=0, **overrides):
    cfg = config_lib.load_config(os.path.join(REPO, path), **overrides)
    model = Wavenet(cfg)
    params = model.init_params(seed, device="cuda")
    return model, params, fk.build_kernel_weights(cfg, params)


def conditioning(model, params, B, L, seed):
    """enc_t [L, B, DW] bf16 from a random mel through the deconv stack."""
    frames = 1 + -(-L // model.cfg.frame_shift)
    mel = torch.rand((B, frames, 80), generator=torch.Generator().manual_seed(seed)).cuda()
    enc = model.deconv_stack(params, mel)
    return enc.transpose(0, 1)[:L].to(torch.bfloat16).contiguous()


def on_cpu(kw):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


def check_kernel(label, cfg, kw, enc_t, seed, rel_tol, cpu_floor=False):
    """Kernel vs plain version on the same inputs; returns (largest
    teacher-forced head-output error, the plain version's CPU-vs-card
    disagreement or None).  Fails if an error exceeds rel_tol * max(|plain|, 1).

    Teacher-forced greedy head outputs are compared directly.  The sampled
    path is checked by replay: the plain sampler applied to the kernel's own
    head outputs with the same Philox draws must give the kernel's audio, and
    the plain network fed that audio must give the kernel's head outputs.
    Two independent free runs (kernel and plain each feeding back its own
    samples) are only logged: a head-output difference far below the
    tolerance still moves a sample by more than one of the 65536 bins, so
    they part within a few steps however right the kernel is.

    cpu_floor: also run the plain version on the CPU, where only the f32
    summation order differs from the plain version on the card, and log how
    far the two plain runs part: no implementation can be held closer to the
    plain version than that."""
    L, B, _ = enc_t.shape
    t = torch.arange(L, device="cuda")[:, None]
    tf = (0.6 * torch.sin(0.03 * t * (1 + torch.arange(B, device="cuda")[None]))).float()

    # teacher-forced, greedy: the network and head
    _, out_k = fk.generate(kw, enc_t, seed, greedy=True, tf=tf, collect_out_params=True)
    _, out_p = fk.generate_plain(kw, enc_t, seed, greedy=True, tf=tf, collect_out_params=True)
    out_k, out_p = fk.unpack_head(cfg, out_k), fk.unpack_head(cfg, out_p)
    require(bool(torch.isfinite(out_k).all()), f"{label}: non-finite kernel output")
    step_err = (out_k - out_p).abs().amax(dim=(0, 2))
    err = float(step_err.max())
    scale = max(float(out_p.abs().max()), 1.0)
    limit = rel_tol * scale
    growth = ", ".join(f"steps <{n} {float(step_err[:n].max()):.3e}" for n in (1, 16, 64) if n < L)
    floor = None
    if cpu_floor:
        _, out_c = fk.generate_plain(on_cpu(kw), enc_t.cpu(), seed, greedy=True, tf=tf.cpu(),
                                     collect_out_params=True)
        floor = float((fk.unpack_head(cfg, out_c) - out_p.cpu()).abs().max())
    log(f"{label} B={B} L={L}: teacher-forced head outputs max|d| kernel-plain {err:.3e} "
        f"({growth}), scale {scale:.3f}, limit {limit:.3e} ({rel_tol:g} x scale)"
        + ("" if floor is None else f"; plain CPU-plain card {floor:.3e}"))
    require(err <= limit, f"{label} B={B}: teacher-forced head outputs differ")

    # sampled free run: sampler exact on the kernel's own head outputs, and the
    # plain network fed the kernel's own audio reproduces those outputs
    audio_k, outs_k = fk.generate(kw, enc_t, seed, collect_out_params=True)
    require(bool(torch.isfinite(audio_k).all()) and float(audio_k.abs().max()) <= 1.0,
            f"{label} B={B}: free-run audio not finite in [-1, 1]")
    replay = fk.resample_plain(cfg, outs_k, seed)
    tol = 2.0 / cfg.quant_chann if cfg.loss_type != "ce" else 1e-5
    d = (replay - audio_k).abs()
    log(f"{label} B={B}: sampled replay max|d| {float(d.max()):.3e} (one bin {tol:.3e}), "
        f"{float((d <= tol).float().mean()):.4f} of samples within one bin")
    require(bool((d[:, :64] <= tol).all()), f"{label} B={B}: sampler replay differs in the first 64 steps")
    require(float((d <= tol).float().mean()) >= 0.999, f"{label} B={B}: sampler replay differs")
    _, outs_p = fk.generate_plain(kw, enc_t, seed, tf=audio_k.T, collect_out_params=True)
    outs_k, outs_p = fk.unpack_head(cfg, outs_k), fk.unpack_head(cfg, outs_p)
    ferr = float((outs_k - outs_p).abs().max())
    flimit = rel_tol * max(float(outs_p.abs().max()), 1.0)
    log(f"{label} B={B}: free-run head outputs vs plain fed the same audio max|d| {ferr:.3e} "
        f"(limit {flimit:.3e})")
    require(ferr <= flimit, f"{label} B={B}: free-run head outputs differ")
    direct = fk.generate_plain(kw, enc_t, seed)
    same = (direct - audio_k).abs() <= tol
    first = int(torch.nonzero(~same.all(0)).min()) if not bool(same.all()) else L
    log(f"{label} B={B}: independent free runs agree within one bin for {first} steps, "
        f"{float(same.float().mean()):.4f} of samples (logged only)")
    return err, floor


def step_counts(cfg, B, out_width):
    """(FLOPs, weight bytes, ring bytes) of one generated sample for the batch."""
    W, GW, S, DW, NL = cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width, cfg.num_layers
    m = GW // 2
    macs = NL * ((3 * W + DW) * GW + m * (W + S)) + W * S + (S + DW) * S + S * out_width
    weight_bytes = 2 * macs + 4 * (NL * (GW + W + S) + 4 * W + 2 * S + out_width)
    ring_bytes = NL * 3 * B * W * 2
    return 2 * B * macs, weight_bytes, ring_bytes


def time_kernel(cfg, kw, enc_t, seed):
    """ms of the kernel, the plain version and cuBLAS on the same per-step
    matmuls, and the card's bound, for one call of TIMED_STEPS steps."""
    L, B, DW = enc_t.shape
    ms = cuda_ms(lambda: fk.generate(kw, enc_t, seed))
    plain_ms = cuda_ms(lambda: fk.generate_plain(kw, enc_t, seed), reps=1)
    W, GW, S = cfg.width, cfg.gate_width, cfg.skip_width
    a = torch.randn((B, 3 * W + DW), device="cuda").to(torch.bfloat16)
    g = torch.randn((B, GW // 2), device="cuda").to(torch.bfloat16)
    w_comb, w_rs = kw["w_comb"], kw["w_rs"]
    d_out = torch.empty((B, GW), device="cuda", dtype=torch.bfloat16)
    rs_out = torch.empty((B, w_rs.shape[2]), device="cuda", dtype=torch.bfloat16)

    def step():
        for li in range(cfg.num_layers):
            torch.mm(a, w_comb[li], out=d_out)
            torch.mm(g, w_rs[li], out=rs_out)

    # one step's matmuls captured once, replayed per step: the yardstick
    # times cuBLAS, not the host's launch rate
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()

    def library():
        for _ in range(L):
            graph.replay()

    library_ms = cuda_ms(library)
    flops, weight_bytes, ring_bytes = step_counts(cfg, B, cfg.out_width)
    io_bytes = weight_bytes + L * B * (DW * 2 + 4)  # each input read once, audio written once
    t_ops, t_bytes = L * flops / PEAK_BF16_FLOPS, io_bytes / PEAK_HBM_BYTES
    stream_bound_ms = 1e3 * L * (weight_bytes + ring_bytes) / PEAK_HBM_BYTES
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "stream_bound_ms": max(1e3 * t_ops, stream_bound_ms),
    }


def kernel_breakdown(kw, enc_t, seed):
    """Device time per CUDA kernel over one generate call, by torch.profiler:
    {kernel name: (launches, mean µs)}, plus the call's wall time in µs."""
    from torch.profiler import ProfilerActivity, profile

    fk.generate(kw, enc_t, seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fk.generate(kw, enc_t, seed)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    out = {}
    for evt in prof.key_averages():
        for name in ("gate_kernel", "resskip_kernel", "head_kernel"):
            if name in evt.key:
                total = getattr(evt, "device_time_total", None) or evt.cuda_time_total
                out[name] = (evt.count, total / max(evt.count, 1))
    return out, wall_us


def synthetic_wavs(B, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 300, size=(B, 1))
    wav = 0.4 * np.sin(2 * np.pi * f0 * t[None]) + 0.02 * rng.randn(B, n)
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def mel_corr(audio, mels, n):
    matched, mismatched = [], []
    for i in range(len(audio)):
        gen = stft.melspectrogram_np(audio[i][:n])
        for j in range(len(mels)):
            c = np.corrcoef(gen.ravel(), mels[j, : gen.shape[0]].ravel())[0, 1]
            (matched if i == j else mismatched).append(c)
    return float(np.mean(matched)), float(np.mean(mismatched))


def golden_model():
    d = os.path.join(GOLDEN, "tiny_mol")
    cfg = config_lib.load_config(os.path.join(d, "meta.json"))
    return Wavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cuda"), d


def student_model(seed=0):
    cfg = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet.json"))
    pwn = ParallelWavenet(cfg)
    return pwn, pwn.init_params(seed, device="cuda")


def flow_inputs(pwn, params, B, L, seed):
    """x [L, B, W] f32 and enc [L, B, DW] bf16 from a random mel through the
    student's shared deconv stack."""
    frames = 1 + -(-L // pwn.cfg.frame_shift)
    g = torch.Generator().manual_seed(seed)
    mel = torch.rand((B, frames, 80), generator=g).cuda()
    enc = pwn._flow_deconv(params, 0, mel).transpose(0, 1)[:L].to(torch.bfloat16).contiguous()
    x = (0.3 * torch.randn((L, B, pwn.cfg.width), generator=g)).cuda()
    return x, enc


def check_flow(label, x, enc, sw, s, nl, num_stages, cpu_floor=False):
    """One-shot kernel vs plain version on the same inputs; returns (kernel
    output, largest error, the plain version's CPU-vs-card distance or None)."""
    out_k = flk.flow_stack(x, enc, sw, s, nl, num_stages)
    torch.cuda.synchronize()
    out_p = flk.flow_stack_plain(x, enc, sw, s, nl, num_stages)
    require(bool(torch.isfinite(out_k).all()), f"{label}: non-finite kernel output")
    err = float((out_k - out_p).abs().max())
    scale = max(float(out_p.abs().max()), 1.0)
    floor = None
    if cpu_floor:
        cpu_sw = {k: v.cpu() for k, v in sw.items()}
        out_c = flk.flow_stack_plain(x.cpu(), enc.cpu(), cpu_sw, s, nl, num_stages)
        floor = float((out_c - out_p.cpu()).abs().max())
    L, B, _ = x.shape
    log(f"{label} B={B} L={L} layers {s}..{s + nl - 1}: max|d| kernel-plain {err:.3e}, scale "
        f"{scale:.3f}, limit {FLOW_REL_TOL * scale:.3e} ({FLOW_REL_TOL:g} x scale), moved "
        f"{float((out_p - x).abs().max()):.3f}"
        + ("" if floor is None else f"; plain CPU-plain card {floor:.3e}"))
    require(err <= FLOW_REL_TOL * scale, f"{label} B={B}: kernel and plain version differ")
    return out_k, err, floor


def check_flow_streaming(x, enc, sw, nl, num_stages, oneshot, chunk):
    """Chained kernel chunks against the one-shot kernel call (bit for bit: the
    arithmetic of a row does not depend on the call it falls in) and the final
    state against the plain version's; returns the state's error."""
    L, B, W = x.shape
    rows = flk.state_rows(0, nl, num_stages)
    state = torch.zeros((rows, B, W), device="cuda")
    state_p = state.clone()
    outs = []
    for c0 in range(0, L, chunk):
        o, state = flk.flow_stack(x[c0 : c0 + chunk], enc[c0 : c0 + chunk], sw, 0, nl, num_stages,
                                  state=state)
        _, state_p = flk.flow_stack_plain(x[c0 : c0 + chunk], enc[c0 : c0 + chunk], sw, 0, nl,
                                          num_stages, state=state_p)
        outs.append(o)
    torch.cuda.synchronize()
    same = bool(torch.equal(torch.cat(outs, 0), oneshot))
    err = float((state - state_p).abs().max())
    scale = max(float(state_p.abs().max()), 1.0)
    log(f"flow streaming B={B} L={L} chunk {chunk} ({rows} state rows): chained == one-shot "
        f"bit for bit: {same}; final state max|d| kernel-plain {err:.3e} "
        f"(limit {FLOW_REL_TOL * scale:.3e})")
    require(same, f"chained chunks of {chunk} differ from the one-shot call")
    require(err <= FLOW_REL_TOL * scale, f"chunk {chunk}: final state differs from the plain one")
    require(bool(torch.equal(state[:2], x[-2:])), "layer 0's state is not the tail of its input")
    return err


def time_flow(x, enc, sw, nl, num_stages):
    """ms of one stack call for the kernel, the plain version and torch.mm on
    the same per-layer products, and the card's bound for the call."""
    L, B, W = x.shape
    DW = enc.shape[-1]
    rows = L * B
    ms = cuda_ms(lambda: flk.flow_stack(x, enc, sw, 0, nl, num_stages))
    plain_ms = cuda_ms(lambda: flk.flow_stack_plain(x, enc, sw, 0, nl, num_stages), reps=1)
    a = torch.randn((rows, 3 * W + DW), device="cuda", dtype=torch.bfloat16)
    g = torch.randn((rows, W // 2), device="cuda", dtype=torch.bfloat16)
    w_comb = torch.cat([sw["w_tap"][:nl].reshape(nl, 3 * W, W), sw["w_cond"][:nl]], 1).contiguous()
    pre = torch.empty((rows, W), device="cuda", dtype=torch.bfloat16)
    res = torch.empty((rows, W), device="cuda", dtype=torch.bfloat16)

    def library():
        for li in range(nl):
            torch.mm(a, w_comb[li], out=pre)
            torch.mm(g, sw["w_res"][li], out=res)

    library_ms = cuda_ms(library)
    del a, g, pre, res
    flops = 2 * rows * nl * ((3 * W + DW) * W + (W // 2) * W)
    io_bytes = rows * (4 * W + 2 * DW + 4 * W) + nl * (2 * ((3 * W + DW) * W + W // 2 * W) + 8 * W)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, io_bytes / PEAK_HBM_BYTES
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes, "flops": flops, "io_bytes": io_bytes}


def student_breakdown(pwn, params, mel):
    """Device time per CUDA kernel over one synthesize_cuda call, by
    torch.profiler: [(kernel name, launches, total ms)] by falling time, and
    the call's wall time in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        parallelgen.synthesize_cuda(pwn, params, mel, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the time of the kernels it launched
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total = getattr(evt, "self_device_time_total", None)
            if total is None:
                total = evt.self_cuda_time_total
            rows.append((evt.key, evt.count, total / 1e3))
    require(rows, "torch.profiler recorded no CUDA kernel")
    return sorted(rows, key=lambda r: -r[2]), wall_ms


def with_plain_flow_kernel(fn):
    """fn() with the wrapper's kernel swapped for its plain version, so that a
    whole path can be held against the same path on the plain kernel."""
    kernel = flk.flow_stack
    flk.flow_stack = lambda x, enc, sw, s, nl, ns, state=None, compact=True: (
        flk.flow_stack_plain(x, enc, sw, s, nl, ns, state, compact))
    try:
        return fn()
    finally:
        flk.flow_stack = kernel


def golden_student():
    d = os.path.join(GOLDEN, "tiny_student")
    cfg = config_lib.load_config(os.path.join(d, "meta.json"))
    return ParallelWavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cuda"), d


def student_phases():
    """Phases 8 to 11; returns the flow kernel's record."""
    # ---- 8. flow kernel vs plain, full width ----
    pwn, params = student_model()
    cfg = pwn.cfg
    ns = cfg.num_stages
    sw = flk.compact_weights(flk.stack_flow_weights(params["flows"][3]))
    x8, enc8 = flow_inputs(pwn, params, B=8, L=8192, seed=31)
    out8, flow_err, flow_floor = check_flow("flow full width", x8, enc8, sw, 0, ns, ns,
                                            cpu_floor=True)
    for B, L, s in ((32, 4096, 10), (3, 1000, 20)):
        xb, encb = flow_inputs(pwn, params, B=B, L=L, seed=32 + B)
        _, err, _ = check_flow("flow full width", xb, encb, sw, s, ns, ns)
        flow_err = max(flow_err, err)
    state_err = max(check_flow_streaming(x8, enc8, sw, ns, ns, out8, chunk)
                    for chunk in (2048, 512))
    del x8, enc8, out8

    # ---- 9. the student path end to end ----
    mels = {B: stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, STUDENT_SAMPLES, 40 + B)).cuda())
            for B in STUDENT_BATCHES}
    L = pwn.sample_length(mels[8].shape[1])
    parallelgen.synthesize_cuda(pwn, params, mels[8][:, :6], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()  # warm-up
    flk.flow_stack.launches = 0
    runs = {}
    for B in STUDENT_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        audio = parallelgen.synthesize_cuda(pwn, params, mels[B], torch.Generator().manual_seed(B))
        torch.cuda.synchronize()
        runs[B] = (audio, time.time() - t0, torch.cuda.max_memory_allocated())
    launches = flk.flow_stack.launches
    for B, (audio, dt, peak) in runs.items():
        require(tuple(audio.shape) == (B, L), f"student path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"student path B={B}: audio not finite in [-1, 1]")
        log(f"student path B={B} L={L}: {1e3 * dt:.1f} ms, {B * L / 16000 / dt:.1f} audio-sec/s, "
            f"audio std {float(audio.std()):.4f}, peak memory {peak / 2**30:.2f} GiB")
    cycles = sum(-(-n // ns) for n in cfg.num_iaf_layers)
    log(f"student path kernel launches: flow_stack {launches} ({cycles} per synthesis, "
        f"{ns} CUDA launches each)")
    require(launches == cycles * len(STUDENT_BATCHES),
            f"the student path launched the flow kernel {launches} times")
    del runs

    # fused feed-forward: the kernel against the same path on the plain kernel
    inputs = {"mel": mels[8], "base_x": pwn.base_noise(torch.Generator().manual_seed(9), 8, L, "cuda")}
    ff_k = parallelgen.feed_forward_cuda(pwn, params, inputs)
    ff_p = with_plain_flow_kernel(lambda: parallelgen.feed_forward_cuda(pwn, params, inputs))
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        err = float((ff_k[k] - ff_p[k]).abs().max())
        scale = max(float(ff_p[k].abs().max()), 1e-3)
        log(f"student feed-forward B=8 {k}: max|d| kernel-plain {err:.3e}, scale {scale:.3e}, "
            f"limit {STUDENT_REL_TOL * scale:.3e}")
        require(err <= STUDENT_REL_TOL * scale, f"student feed-forward {k} differs")
    # the streamer entry point at full width: bucketless encoding, carried state
    # of all 6 cycles and the start conv's window, against the one-shot path
    one = pwn._clip_quant_scale(ff_k["x"])
    streamer = parallelgen.StudentStreamer(pwn, chunk=32768)
    streamer.synthesize(params, mels[8][:, :6], base_x=inputs["base_x"][:, :pwn.sample_length(6)])
    torch.cuda.synchronize()  # warm-up
    t0 = time.time()
    streamed = streamer.synthesize(params, mels[8], base_x=inputs["base_x"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    sdiff = float((streamed - one).abs().max())
    log(f"student streamer B=8 L={L} chunk 32768: {1e3 * dt:.1f} ms, "
        f"{8 * L / 16000 / dt:.1f} audio-sec/s; vs one-shot on the same noise max|d| {sdiff:.3e} "
        f"(limit 5e-3)")
    require(tuple(streamed.shape) == (8, L) and sdiff <= 5e-3,
            "full-width streamer differs from the one-shot path")
    del ff_k, ff_p, inputs, one, streamed

    kernels, wall_ms = student_breakdown(pwn, params, mels[8])
    busy = sum(ms for _, _, ms in kernels)
    log(f"profile student B=8: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall; " + ", ".join(
        f"{name[:48]} {n} x {1e3 * ms / n:.1f} us" for name, n, ms in kernels[:6]))

    B = STUDENT_BATCHES[0]
    enc = parallelgen._trim_to(pwn._flow_deconv(params, 0, mels[B]), L)
    enc = enc.transpose(0, 1).to(torch.bfloat16).contiguous()
    x = (0.3 * torch.randn((L, B, cfg.width), generator=torch.Generator().manual_seed(1))).cuda()
    # the kernel against its plain version at the main path's own shape, for
    # each offset of a cycle in the 30-layer flow
    for s in range(0, cfg.num_iaf_layers[3], ns):
        out_k, err, _ = check_flow("flow main-path shape", x, enc, sw, s, ns, ns)
        del out_k
        flow_err = max(flow_err, err)
    tm = time_flow(x, enc, sw, ns, ns)
    log(f"timing flow_stack B={B} L={L}, {ns} layers: kernel {tm['ms']:.3f} ms, plain "
        f"{tm['plain_ms']:.3f} ms, torch.mm on the same products {tm['library_ms']:.3f} ms, bound "
        f"{tm['bound_ms']:.3f} ms ({tm['bound_by']}; operations {tm['ops_ms']:.3f} ms, bytes "
        f"{tm['bytes_ms']:.3f} ms); {tm['flops'] / 1e12:.3f} TFLOP, {tm['io_bytes'] / 1e9:.3f} GB; "
        f"{cycles} calls per synthesis")
    del x, enc

    # ---- 10. golden tiny_student on the card ----
    gpwn, gparams, gdir = golden_student()
    n = 12000
    wavs = [wav_io.read_wav(os.path.join(GOLDEN, f"gen_student_{i}.wav"))[0][:n] for i in range(4)]
    gmels_np = stft.melspectrogram_np(np.stack(wavs))
    gmels = torch.from_numpy(gmels_np).cuda()
    gL = gpwn.sample_length(gmels.shape[1])
    gin = {"mel": gmels,
           "base_x": gpwn.base_noise(torch.Generator().manual_seed(7), 4, gL, "cuda")}
    fused = gpwn._clip_quant_scale(parallelgen.feed_forward_cuda(gpwn, gparams, gin)["x"])
    plain = gpwn._clip_quant_scale(gpwn.feed_forward(gparams, gin)["x"])
    corr = float(np.corrcoef(fused.cpu().numpy().ravel(), plain.cpu().numpy().ravel())[0, 1])
    streamed = parallelgen.StudentStreamer(gpwn, chunk=1024).synthesize(
        gparams, gmels, base_x=gin["base_x"])
    sdiff = float((streamed - fused).abs().max())
    log(f"golden student: fused vs plain audio corr {corr:.6f}; streamer (chunk 1024) vs one-shot "
        f"max|d| {sdiff:.3e}")
    require(corr > 0.999, "golden student: fused and plain audio differ")
    require(sdiff <= 5e-3, "golden student: streamer differs from one-shot")
    audio = parallelgen.synthesize_cuda(gpwn, gparams, gmels,
                                        torch.Generator().manual_seed(7)).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden student audio")
    matched, mismatched = mel_corr(audio, gmels_np, min(n, gL))
    log(f"golden student free synthesis mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden student does not track its conditioning")

    # ---- 11. the student eval path on golden weights ----
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        for i in (0, 1):
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wavs[i])
        for chunk in (None, 2000):
            paths = generate_parallel_wavenet(
                src, os.path.join(gdir, "params.npz"), os.path.join(gdir, "meta.json"),
                os.path.join(tmp, f"gen_{chunk}"), batch_size=4, seed=0, device="cuda",
                sample_length=8000, streaming_chunk=chunk)
            require(len(paths) == 2, f"student eval wrote {len(paths)} files")
            for p in paths:
                wav, sr = wav_io.read_wav(p)
                require(sr == 16000 and len(wav) >= 8000 and np.isfinite(wav).all()
                        and np.abs(wav).max() > 0, f"student eval output {p}")
            log(f"student eval path (streaming_chunk {chunk}) wrote "
                f"{[os.path.basename(p) for p in paths]}")

    log(f"timed flow call: B={B}, L={L}, {ns} layers, full width")
    return {
        "name": "flow_stack",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/flow_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/flow_kernel.py:47",
        "launches": launches,
        "max_abs_err": flow_err,
        "rel_tol": FLOW_REL_TOL,
        "plain_cpu_vs_card_err": flow_floor,
        "state_max_abs_err": state_err,
        "ms": tm["ms"],
        "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"],
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # ---- 1. device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.time()
    for name, (path, report) in build.build_all().items():
        log(f"built {name} -> {os.path.relpath(path, REPO)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
    log(f"kernel build {time.time() - t0:.1f} s")

    # ---- 2. full-width MoL kernel vs plain ----
    model, params, kw = full_model("configs/wavenet_mol.json")
    cfg = model.cfg
    enc_t = conditioning(model, params, B=8, L=256, seed=1)
    full_err, full_floor = check_kernel("mol full width", cfg, kw, enc_t, seed=5,
                                        rel_tol=FULL_WIDTH_REL_TOL, cpu_floor=True)

    # ---- 3. the other heads, and trained golden weights ----
    for path in ("configs/wavenet_ce.json", "configs/wavenet_gauss.json"):
        m3, p3, kw3 = full_model(path, num_layers=4)
        check_kernel(f"{m3.cfg.loss_type} 4 layers", m3.cfg, kw3,
                     conditioning(m3, p3, B=8, L=256, seed=2), seed=6, rel_tol=REL_TOL)
    gmodel, gparams, gdir = golden_model()
    check_kernel("golden tiny_mol", gmodel.cfg, fk.build_kernel_weights(gmodel.cfg, gparams),
                 conditioning(gmodel, gparams, B=8, L=256, seed=3), seed=7, rel_tol=REL_TOL)

    # ---- 4. Philox uniforms from the kernel's generator ----
    u = fk.philox_uniform(7, 11, 256, 1024, 0, device="cuda")
    require(bool(torch.equal(u, fk.philox_uniform_plain(7, 11, 256, 1024, 0, device="cuda"))),
            "kernel Philox differs from the plain version")
    un = u.cpu().numpy()
    log(f"philox [256,1024]: min {un.min():.3e} max {un.max():.6f} mean {un.mean():.5f} "
        f"var {un.var():.5f} floor share {(un <= 1e-5).mean():.2e}")
    require(un.min() >= 1e-5 and un.max() <= 1 - 1e-5 and (un <= 1e-5).mean() < 1e-2
            and un.max() > 0.99 and abs(un.mean() - 0.5) < 0.02 and abs(un.var() - 1 / 12) < 2e-3,
            "Philox uniform statistics")

    calls = 100  # per timed run, so that the events do not time one launch's latency
    philox_us = 1e3 / calls * cuda_ms(lambda: [fk.philox_uniform(7, 11, 256, 1024, 0, device="cuda")
                                               for _ in range(calls)])
    rand_us = 1e3 / calls * cuda_ms(lambda: [torch.rand((256, 1024), device="cuda")
                                             for _ in range(calls)])
    log(f"philox [256,1024]: {philox_us:.2f} us per call (wrapper, allocation and launch "
        f"included), torch.rand {rand_us:.2f} us, bound {1e6 * 256 * 1024 * 4 / PEAK_HBM_BYTES:.3f} us "
        f"(1 MiB written)")

    # ---- 5. main path end to end ----
    fg = Fastgen(model)
    mels = {}
    for B in MAIN_BATCHES:
        mels[B] = stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, MAIN_LENGTH, B)).cuda())
    fg.generate_cuda(params, mels[MAIN_BATCHES[0]], seed=0, length=16, kw=kw)  # warm-up
    torch.cuda.synchronize()
    fk.generate.launches = 0
    main_runs = {}
    for B in MAIN_BATCHES:
        t0 = time.time()
        audio = fg.generate_cuda(params, mels[B], seed=B, length=MAIN_LENGTH, kw=kw)
        torch.cuda.synchronize()
        dt = time.time() - t0
        main_runs[B] = (audio, dt)
    launches = fk.generate.launches
    for B, (audio, dt) in main_runs.items():
        require(tuple(audio.shape) == (B, MAIN_LENGTH), f"main path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"main path B={B}: audio not finite in [-1, 1]")
        log(f"main path B={B} L={MAIN_LENGTH}: {dt:.3f} s, {1e6 * dt / MAIN_LENGTH:.1f} us/step, "
            f"{B * MAIN_LENGTH / 16000 / dt:.2f} audio-sec/s, audio std {float(audio.std()):.4f}")
    log(f"main path kernel launches: generate {launches} "
        f"({2 * cfg.num_layers + 1} CUDA launches per step each)")
    require(launches > 0, "the main path did not launch the CUDA kernel")

    # the kernel against its plain version at the main path's batches: every
    # batch tile and head block of the full-width kernel meets the plain version
    for B in MAIN_BATCHES:
        err, _ = check_kernel("mol full width", cfg, kw,
                              conditioning(model, params, B=B, L=CHECK_STEPS, seed=20 + B),
                              seed=8, rel_tol=FULL_WIDTH_REL_TOL)
        full_err = max(full_err, err)

    timings = {}
    for B in MAIN_BATCHES:
        enc = conditioning(model, params, B=B, L=TIMED_STEPS, seed=10 + B)
        timings[B] = time_kernel(cfg, kw, enc, seed=1)
        tm = timings[B]
        flops, weight_bytes, ring_bytes = step_counts(cfg, B, cfg.out_width)
        log(f"timing B={B} {TIMED_STEPS} steps: kernel {tm['ms']:.3f} ms "
            f"({1e3 * tm['ms'] / TIMED_STEPS:.1f} us/step), plain {tm['plain_ms']:.3f} ms, "
            f"cuBLAS per-step matmuls {tm['library_ms']:.3f} ms, bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']}), weight-streaming bound {tm['stream_bound_ms']:.3f} ms; "
            f"per step {flops / 1e9:.2f} GFLOP, {weight_bytes / 1e6:.1f} MB weights, "
            f"{ring_bytes / 1e6:.2f} MB ring")
        steps = 16
        kernels, wall_us = kernel_breakdown(kw, enc[:steps].contiguous(), seed=1)
        busy = sum(n * us for n, us in kernels.values())
        log(f"profile B={B} {steps} steps: " + ", ".join(
            f"{k} {n} x {us:.1f} us" for k, (n, us) in sorted(kernels.items()))
            + f"; device busy {busy / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall")

    # ---- 6. eval CLI path on golden weights ----
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "src"), os.path.join(tmp, "gen")
        os.makedirs(src)
        for i in (0, 1):
            wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wav)
        paths = generate_wavenet(src, os.path.join(gdir, "params.npz"),
                                 os.path.join(gdir, "meta.json"), out, batch_size=8, seed=0,
                                 device="cuda", sample_length=4000)
        require(len(paths) == 2, f"eval wrote {len(paths)} files")
        for p in paths:
            wav, sr = wav_io.read_wav(p)
            require(sr == 16000 and len(wav) >= 4000 and np.isfinite(wav).all(), f"eval output {p}")
        log(f"eval path wrote {[os.path.basename(p) for p in paths]}")

    # ---- 7. golden free run tracks its conditioning ----
    n = 8000
    wavs = [wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))[0][:n] for i in (0, 1)]
    gmels = stft.melspectrogram_np(np.stack(wavs))
    audio = Fastgen(gmodel).generate_cuda(gparams, torch.from_numpy(gmels).cuda(), seed=7,
                                          length=n).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden free-run audio")
    matched, mismatched = mel_corr(audio, gmels, n)
    log(f"golden free run mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden free run does not track its conditioning")

    del model, params, kw, fg, mels, main_runs, gmodel, gparams
    torch.cuda.empty_cache()
    flow_record = student_phases()

    big = timings[MAIN_BATCHES[-1]]
    record = {"kernels": [{
        "name": "fastgen_generate",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/fastgen_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/fastgen_kernel.py:291",
        "launches": launches,
        "max_abs_err": full_err,
        "rel_tol": FULL_WIDTH_REL_TOL,
        "plain_cpu_vs_card_err": full_floor,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }, flow_record]}
    log(f"timed call: B={MAIN_BATCHES[-1]}, {TIMED_STEPS} steps, full width; "
        f"total {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
