"""Time the AR generation kernel of this tree against another tree's, in turns.

    python3 ab_fastgen.py --other <dir>          # e.g. an unpacked `git archive` of the parent
    python3 ab_fastgen.py --other <dir> --cases bf16_64,bf16_512
    python3 ab_fastgen.py --other <dir> --facts  # both trees' compiler reports and machine code
    python3 ab_fastgen.py --probe [--cases bf16_512]  # this tree alone

Needs one CUDA card and the CUDA toolkit.  Runs four passes (other, this,
this, other), each in a fresh process in its own tree, through ab_turns.py,
which prints one "AB <tree> <nvidia-smi name, power limit> <json>" line a
pass and, last, this tree's time over the other's for each case.  A pass
times one call of chip_smoke.TIMED_STEPS steps (median of 5 by CUDA events)
of the full-width MoL teacher (configs/wavenet_mol.json, random weights from
seed 0) in bf16, W8A8 static (calibrated as chip_smoke.py calibrates) and
W8A8 per-row, at B = 64 and 512, and W8A8 static at B = 896 (or only the
--cases named <mode>_<B>); the first pass of this tree also times the
library yardstick (cuBLAS / torch._int_mm graph of one step's products), the
plain version and the card's bound (chip_smoke.time_kernel).

--facts compiles each tree's generation library afresh and prints, for every
kernel in it, its lines of the compiler's resource report and a digest of
its machine code (ab_turns.library_facts), then whether each kernel's facts
are equal in the two trees.

The pre-pass cases (--cases prepass_896,peak_896,modes_digest; not run
unless named) compare the int8 modes' conditioning pre-pass of the two trees
on an encoding held as the deconv leaves it (channel by channel), random
from a seed: prepass_896 profiles one W8A8 static generate_cuda call of the
full-width teacher cut to 1 layer at B = 896 x 16 000 steps (cond_offset 7)
and counts as the pre-pass every kernel of the call but fastgen_persistent
(a tree that copies the window time-major first counts that copy too; this
tree also times quant_enc_kernel alone by CUDA events); peak_896 gives the
peak device memory above the encoding of that call one-shot and in chunks
of 2 000; modes_digest hashes the audio of all nine (activation, res/skip)
modes at 4 layers, B = 64 x 300 steps, one-shot and in chunks of 128, which
ab_turns compares across the passes (same_output).

The generator cases (--cases philox_256mib,philox_1mib_graph; not run
unless named) time philox_uniform on the device alone in turns, rep by rep
(ab_turns.interleaved, median of 25), per call: a CUDA graph of 10
[65536, 1024] calls (256 MiB written each; philox_256mib) and one of 100
[256, 1024] calls (philox_1mib_graph); each also hashes the generator's output at
[256, 1024], [65536, 1024], [1, 1], [3, 1000] and [7, 4097] under (seed, t,
draw) (7, 11, 0) and (-1, 2**31 - 1, 1), which ab_turns compares across the
passes (same_output).

--facts covers the serving library and both probe libraries, so it shows
whether every fastgen_persistent and quant_enc_kernel instantiation kept
its resources and machine code.

--probe times, in this tree alone, the same call (--cases: every mode at
B = 64 and 512 by default) and its perf probes, generate(probe="cheap_gate")
and generate(probe="no_ring_write"), in turns, rep by rep (median of 7 after
a warm-up call each), prints each one's median and its difference from the
full call of the same rep, and requires each probe call's grid barriers,
as the kernel counted them, to be the full call's 2 * NL + 3 a step.
"""

import os
import sys

import ab_turns

TIMED_CASES = ("bf16_64", "static_64", "row_64", "bf16_512", "static_512", "row_512", "static_896")
PREPASS_CASES = ("prepass_896", "peak_896", "modes_digest")
PHILOX_CASES = ("philox_256mib", "philox_1mib_graph")
CASES = TIMED_CASES + PREPASS_CASES + PHILOX_CASES
DEFAULT_CASES = TIMED_CASES  # what a run times when --cases is not given
PROBE_CASES = TIMED_CASES[:-1]  # what --probe times when --cases is not given
PREPASS_B, PREPASS_L, PREPASS_OFFSET = 896, 16000, 7


def facts():
    """ab_turns.library_facts of the generation library of the working
    directory's tree and of its two probe libraries."""
    return ab_turns.library_facts("fastgen_kernel", "fastgen_kernel_cheap_gate",
                                  "fastgen_kernel_no_ring_write")


def _setup():
    """(chip_smoke, the full-width MoL teacher, its params, its packed weights
    by mode) in the tree of the working directory, TF32 off."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params, kw_bf16 = cs.full_model("configs/wavenet_mol.json")
    kw_static, _ = cs.calibrated_w8a8(model, params, cs.synthetic_wavs(8, 16000, 77))
    kws = {"bf16": kw_bf16, "static": kw_static,
           "row": fk.build_kernel_weights(model.cfg, params, weight_dtype="int8")}
    return cs, model, params, kws


def probe_pass(cases):
    """The full call of each of ``cases`` and its perf probes, timed in turns
    (ab_turns.interleaved, 7 reps) in the working directory's tree; returns
    {case: {"full" | probe: timing (and its µs a step), "barriers_per_step"}}."""
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    cs, model, params, kws = _setup()
    out = {}
    for case in cases:
        mode, B = case.split("_")[0], int(case.split("_")[1])
        enc = cs.conditioning(model, params, B=B, L=cs.TIMED_STEPS, seed=10 + B)
        kw = kws[mode]
        calls = {"full": lambda: fk.generate(kw, enc, 1)}
        for probe in fk.PROBES:
            calls[probe] = (lambda probe=probe: fk.generate(kw, enc, 1, probe=probe,
                                                            allow_wrong_output=True))
        res = ab_turns.interleaved(calls, reps=7)
        barriers = {}
        for name, fn in calls.items():
            fn()
            barriers[name] = cs.require_barriers(f"{case} {name}", model.cfg)
        for name, r in res.items():
            r.update(us_per_step=1e3 * r["ms"] / cs.TIMED_STEPS,
                     minus_full_us_per_step=1e3 * r["minus_full_ms"] / cs.TIMED_STEPS)
        print(f"probe {case}: " + ", ".join(
            f"{k} {v['us_per_step']:.1f} us/step ({v['minus_full_us_per_step']:+.1f} us, "
            f"{100 * v['share_of_full']:+.1f} %)" for k, v in res.items()), flush=True)
        out[case] = dict(res, barriers_per_step=barriers)
    return out


def _deconv_like(B, T, DW, seed):
    """A random bf16 encoding [B, T, DW] held channel by channel (time
    contiguous), as the deconv stack leaves its output."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, DW, T), device="cuda", generator=g).to(torch.bfloat16).transpose(1, 2)


def prepass_pass(cs, case):
    """One pre-pass case (PREPASS_CASES) in the working directory's tree."""
    import hashlib
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    if case == "modes_digest":
        model, params, _ = cs.full_model("configs/wavenet_mol.json", num_layers=4)
        fg, amax = Fastgen(model), torch.full((4,), 3.0)
        enc = _deconv_like(64, 320, model.cfg.deconv_width, seed=3)
        sha = {}
        for act in ("bf16", "static", "row"):
            for rs in ("bf16", "static", "row"):
                build = {"weight_dtype": "bf16" if act == "bf16" else "int8",
                         "act_amax": amax if act == "static" else None,
                         "rs_dtype": "bf16" if rs == "bf16" else "int8", "gate_static": rs == "static"}
                kw = fk.build_kernel_weights(model.cfg, params, **build)
                runs = {c: fg.generate_cuda(params, None, seed=5, length=300, cond_offset=11, kw=kw,
                                            encoding=enc, chunk=c) for c in (None, 128)}
                sha[f"{act}/{rs}"] = {"one_shot" if c is None else "chunked":
                                      hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]
                                      for c, a in runs.items()}
        return {"sha": sha}
    # the full-width teacher cut to 1 layer, W8A8 static with a fixed abs-max
    model, params, _ = cs.full_model("configs/wavenet_mol.json", num_layers=1)
    fg = Fastgen(model)
    kw = fk.build_kernel_weights(model.cfg, params, weight_dtype="int8",
                                 act_amax=torch.full((1,), 3.0), gate_static=True)
    B, L, off = PREPASS_B, PREPASS_L, PREPASS_OFFSET
    DW = model.cfg.deconv_width
    enc = _deconv_like(B, L + 16, DW, seed=5)
    if case == "peak_896":
        peak = {}
        for chunk in (None, 2000):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fg.generate_cuda(params, None, seed=1, length=L, cond_offset=off, kw=kw, encoding=enc,
                             chunk=chunk)
            torch.cuda.synchronize()
            peak["one_shot" if chunk is None else "chunked"] = (
                (torch.cuda.max_memory_allocated() - base) / 1e9)
        return {"peak_gb": peak}
    call = lambda: fg.generate_cuda(params, None, seed=1, length=L, cond_offset=off, kw=kw,
                                    encoding=enc)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.25)
        call()
        torch.cuda.synchronize()
        time.sleep(0.25)
    kernels = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total = getattr(evt, "self_device_time_total", None)
            kernels[evt.key[:80]] = (total if total is not None else evt.self_cuda_time_total) / 1e3
    prepass = {k: ms for k, ms in kernels.items() if "fastgen_persistent" not in k}
    out = {"ms": sum(prepass.values()), "kernels_ms": prepass,
           "bound_ms": 1e3 * L * B * (DW * 2 + DW * 3 + 4) / cs.PEAK_HBM_BYTES}
    win = enc.transpose(0, 1)[off : off + L]
    out["copy_ms"] = cs.cuda_ms(lambda: win.contiguous(), reps=5)  # the bf16 mode's own pre-pass
    if hasattr(fk, "enc_prepass"):
        out["fused_ms"] = cs.cuda_ms(lambda: fk.enc_prepass(win), reps=5)
    return out


def philox_pass(cs, cases):
    """The generator cases (PHILOX_CASES) of ``cases``, timed together in
    turns in the working directory's tree, each with a digest of the output."""
    import hashlib

    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    sha = hashlib.sha256()
    for seed, t, draw in ((7, 11, 0), (-1, 2**31 - 1, 1)):
        for rows, lanes in ((256, 1024), (65536, 1024), (1, 1), (3, 1000), (7, 4097)):
            sha.update(fk.philox_uniform(seed, t, rows, lanes, draw, device="cuda").cpu().numpy().tobytes())
    per = {"philox_256mib": 10, "philox_1mib_graph": 100}  # calls a graph
    graph_rows = {"philox_256mib": 65536, "philox_1mib_graph": 256}
    res = ab_turns.interleaved({c: cs.replay_graph(
        lambda c=c: [fk.philox_uniform(7, 11, graph_rows[c], 1024, 0, device="cuda")
                     for _ in range(per[c])],
        1) for c in cases}, reps=25)
    return {c: {"ms": res[c]["ms"] / per[c], "min_ms": res[c]["min_ms"] / per[c],
                "sha": sha.hexdigest()[:16]} for c in cases}


def one_pass(full, cases):
    """Time ``cases`` in the tree of the working directory; returns a dict."""
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    philox = [c for c in cases if c in PHILOX_CASES]
    if all(c in PREPASS_CASES + PHILOX_CASES for c in cases):
        import chip_smoke as cs

        out = {case: prepass_pass(cs, case) for case in cases if case in PREPASS_CASES}
        return {**out, **(philox_pass(cs, philox) if philox else {})}
    cs, model, params, kws = _setup()
    out = philox_pass(cs, philox) if philox else {}
    for case in cases:
        if case in PHILOX_CASES:
            continue
        if case in PREPASS_CASES:
            out[case] = prepass_pass(cs, case)
            continue
        mode, B = case.split("_")[0], int(case.split("_")[1])
        enc = cs.conditioning(model, params, B=B, L=cs.TIMED_STEPS, seed=10 + B)
        kw = kws[mode]
        if full:
            tm = cs.time_kernel(model.cfg, kw, enc, seed=1)
            out[case] = {k: tm[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                                            "stream_bound_ms")}
        else:
            out[case] = {"ms": cs.cuda_ms(lambda: fk.generate(kw, enc, 1), reps=5)}
    return out


if __name__ == "__main__":
    sys.exit(ab_turns.main(__doc__, CASES, one_pass, facts, probe=probe_pass,
                           probe_cases=PROBE_CASES, default_cases=DEFAULT_CASES))
