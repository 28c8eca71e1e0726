"""Time the flow-stack kernel of this tree against another tree's, in turns.

    python3 ab_flow.py --other <dir>          # e.g. an unpacked `git archive` of the parent
    python3 ab_flow.py --other <dir> --cases bf16,synth_bf16
    python3 ab_flow.py --other <dir> --facts  # the compiler's report of both trees' flow kernels
    python3 ab_flow.py --other <dir> --width 256 [--batch 8 --samples 16000]
    python3 ab_flow.py --probe [--width 128] [--cases bf16,f32cond]   # this tree alone

Needs one CUDA card and the CUDA toolkit.  Runs four passes (other, this,
this, other), each in a fresh process in its own tree, through ab_turns.py,
which prints one "AB <tree> <nvidia-smi name, power limit> <json>" line a
pass and, last, this tree's time over the other's for each case.  A pass
works at the full depth of configs/parallel_wavenet.json (deconv width 256,
random weights from seed 0) at the width --width (32, 64, 128 or 256;
default 64, the config's own) on the student path's own stream,
B = --batch x --samples (default 32 x 4 s: L = 64 000 rows a batch row), and times:
  - one 10-layer call of flow_stack (layers 0-9 of the 30-layer flow; median
    of 5 by CUDA events, after one warm-up call) in every mode: bf16 (the
    compact mode), f32cond, fuse_cond (bf16 operands, as parallelgen passes
    them), the bf16 and f32 cond streams, and with a carried state (bf16 and
    f32cond);
  - parallelgen.synthesize_cuda on the same batch, bf16 and f32 students, in
    steady state: one warm call, then the median of 5 by CUDA events;
  - StudentStreamer.synthesize of the bf16 student in chunks of 1 024 and
    32 768 samples on fixed base noise (streamer_1024, streamer_32768), the
    median of 3 after a warm call, with a digest of its audio that ab_turns
    compares across the passes of both trees (same_output).
The first pass of this tree also gives, for each flow case, the plain
version's time, the torch.mm yardstick on the same products and the card's
bound (chip_smoke.time_flow).

--facts compiles each tree's flow library afresh and prints, for every flow
kernel in it, the lines of the compiler's resource report (ptxas -v:
registers a thread, spill bytes, static shared memory) and a digest of its
machine code (ab_turns.library_facts), then whether each kernel's facts are
equal in the two trees.

--probe times, in this tree alone, the same 10-layer call (--cases bf16 and
f32cond by default) and its perf probes, flow_stack(probe="no_gate") and
flow_stack(probe="no_slide"), in turns, rep by rep (median of 9 after a
warm-up call each), and prints each one's median and its difference from
the full call of the same rep.
"""

import dataclasses
import hashlib
import os
import sys

import ab_turns

FLOW_CASES = ("bf16", "f32cond", "fuse_cond", "stream", "stream_f32", "state", "state_f32cond")
SYNTH_CASES = ("synth_bf16", "synth_f32")
STREAMER_CASES = ("streamer_1024", "streamer_32768")
CASES = FLOW_CASES + SYNTH_CASES + STREAMER_CASES
PROBE_CASES = ("bf16", "f32cond")  # what --probe times when --cases is not given
OPTIONS = (("--width", {"type": int, "default": 64, "choices": (32, 64, 128, 256),
                        "help": "the student's width"}),
           ("--batch", {"type": int, "default": 32, "help": "utterances a call"}),
           ("--samples", {"type": int, "default": 64000, "help": "samples an utterance"}))


def facts():
    """ab_turns.library_facts of the flow library of the working directory's tree."""
    return ab_turns.library_facts("flow_kernel")


def _setup(width, batch, samples):
    """(chip_smoke, the student, its f32 twin, their params, the mel of
    ``batch`` utterances of ``samples`` samples) in the working directory's
    tree, TF32 off."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.ops import stft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pwn, params = cs.student_model(width=width)
    pwn32 = ParallelWavenet(dataclasses.replace(pwn.cfg, compute_dtype="float32"))
    mel = stft.melspectrogram(torch.from_numpy(cs.synthetic_wavs(batch, samples, 40 + batch)).cuda())
    return cs, pwn, pwn32, params, mel


def _flow_inputs(pwn, pwn32, params, mel):
    """The 10-layer call's inputs: x, the f32 encoding, {case: (encoding,
    weights, flow_stack options)} of every FLOW_CASES case but the streams,
    and the stacked weights, as they are, compact and non-compact."""
    import torch

    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk

    bf = torch.bfloat16
    ns, W, B = pwn.cfg.num_stages, pwn.cfg.width, mel.shape[0]
    L = pwn.sample_length(mel.shape[1])
    with torch.no_grad():
        enc32 = parallelgen._trim_to(pwn32._flow_deconv(params, 0, mel), L)
    enc32 = enc32.transpose(0, 1).float().contiguous()
    enc = enc32.to(bf)
    x = (0.3 * torch.randn((L, B, W), generator=torch.Generator().manual_seed(1))).cuda()
    sw = flk.stack_flow_weights(params["flows"][3])
    cw, nw = flk.compact_weights(sw), flk.noncompact_weights(sw)
    fw = dict(nw, w_cond=nw["w_cond"].to(bf))  # fuse_cond's operands, cast once a flow
    st0 = torch.zeros((flk.state_rows(0, ns, ns), B, W), device="cuda")
    inputs = {
        "bf16": (enc, cw, {}),
        "f32cond": (enc32, nw, {"compact": False}),
        "fuse_cond": (enc, fw, {"compact": False, "fuse_cond": True}),
        "state": (enc, cw, {"state": st0}),
        "state_f32cond": (enc32, nw, {"state": st0, "compact": False}),
    }
    return x, enc32, inputs, (sw, cw, nw)


def probe_pass(cases, width=64, batch=32, samples=64000):
    """The full 10-layer call of each of ``cases`` and its perf probes, timed
    in turns (ab_turns.interleaved, 9 reps) in the working directory's tree;
    returns {case: {"full" | probe: timing, "shape": the call's}}."""
    from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk

    _, pwn, pwn32, params, mel = _setup(width, batch, samples)
    x, _, inputs, _ = _flow_inputs(pwn, pwn32, params, mel)
    ns = pwn.cfg.num_stages
    out = {}
    for case in cases:
        e, wts, kw = inputs[case]
        calls = {"full": lambda: flk.flow_stack(x, e, wts, 0, ns, ns, **kw)}
        for probe in flk.PROBES:
            calls[probe] = (lambda probe=probe: flk.flow_stack(
                x, e, wts, 0, ns, ns, probe=probe, allow_wrong_output=True, **kw))
        out[case] = ab_turns.interleaved(calls, reps=9)
        print(f"probe {case} W={pwn.cfg.width} B={x.shape[1]} L={x.shape[0]}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({v['minus_full_ms']:+.3f} ms, {100 * v['share_of_full']:+.1f} %)"
            for k, v in out[case].items()), flush=True)
        out[case]["shape"] = {"W": pwn.cfg.width, "B": x.shape[1], "L": x.shape[0], "layers": ns}
    return out


def one_pass(full, cases, width=64, batch=32, samples=64000):
    """Time ``cases`` in the tree of the working directory at the student's
    ``width``, ``batch`` utterances of ``samples`` samples; returns a dict."""
    import torch

    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk

    bf = torch.bfloat16
    cs, pwn, pwn32, params, mel = _setup(width, batch, samples)
    ns = pwn.cfg.num_stages
    out = {}
    if any(c in FLOW_CASES for c in cases):
        x, enc32, inputs, (sw, cw, nw) = _flow_inputs(pwn, pwn32, params, mel)
        for case in FLOW_CASES:
            if case not in cases:
                continue
            if case.startswith("stream"):
                # made for its own case only (W 256 at B = 32 x L = 64 000: 21 GB in f32),
                # so that the plain version's products fit beside it
                c32 = cs.stream_of(enc32, sw, 0, ns)
                e, wts, kw = ((None, cw, {"cond": c32.to(bf)}) if case == "stream" else
                              (None, nw, {"cond": c32, "compact": False}))
                del c32
            else:
                e, wts, kw = inputs[case]
            if full:
                tm = cs.time_flow(x, e, wts, ns, ns, **kw)
                out[case] = {k: tm[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "bytes_ms", "layer_floor_ms")}
            else:
                out[case] = {"ms": cs.cuda_ms(lambda: flk.flow_stack(x, e, wts, 0, ns, ns, **kw),
                                              reps=5)}
            del e, kw
        del x, enc32, inputs
    for case, model in (("synth_bf16", pwn), ("synth_f32", pwn32)):
        if case in cases:
            out[case] = {"ms": cs.cuda_ms(lambda: parallelgen.synthesize_cuda(
                model, params, mel, torch.Generator().manual_seed(0)), reps=5)}
    base_x = pwn.base_noise(torch.Generator().manual_seed(3), mel.shape[0],
                            pwn.sample_length(mel.shape[1]), "cuda")
    for case in STREAMER_CASES:
        if case in cases:
            streamer = parallelgen.StudentStreamer(pwn, chunk=int(case.split("_")[1]))
            audio = streamer.synthesize(params, mel, base_x=base_x)
            out[case] = {"ms": cs.cuda_ms(lambda: streamer.synthesize(params, mel, base_x=base_x),
                                          reps=3),
                         "sha": hashlib.sha256(audio.cpu().numpy().tobytes()).hexdigest()[:16]}
    return out


if __name__ == "__main__":
    sys.exit(ab_turns.main(__doc__, CASES, one_pass, facts, OPTIONS, probe=probe_pass,
                           probe_cases=PROBE_CASES, default_cases=FLOW_CASES + SYNTH_CASES))
