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
  7. a golden free run that must track its conditioning.
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
from nsynth_wavenet_tpu_torch.evaluation import generate_wavenet
from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
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
    }]}
    log(f"timed call: B={MAIN_BATCHES[-1]}, {TIMED_STEPS} steps, full width; "
        f"total {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
