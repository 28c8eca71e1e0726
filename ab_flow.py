"""Time the flow-stack kernel of this tree against another tree's, in turns.

    python3 ab_flow.py --other <dir>          # e.g. an unpacked `git archive` of the parent
    python3 ab_flow.py --other <dir> --cases bf16,synth_bf16
    python3 ab_flow.py --other <dir> --facts  # the compiler's report of both trees' flow kernels
    python3 ab_flow.py --other <dir> --width 256 [--batch 8 --samples 16000]

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
    steady state: one warm call, then the median of 5 by CUDA events.
The first pass of this tree also gives, for each flow case, the plain
version's time, the torch.mm yardstick on the same products and the card's
bound (chip_smoke.time_flow).

--facts compiles each tree's flow library afresh and prints, for every flow
kernel in it, the lines of the compiler's resource report (ptxas -v:
registers a thread, spill bytes, static shared memory).
"""

import dataclasses
import os
import re
import shutil
import sys

import ab_turns

FLOW_CASES = ("bf16", "f32cond", "fuse_cond", "stream", "stream_f32", "state", "state_f32cond")
SYNTH_CASES = ("synth_bf16", "synth_f32")
CASES = FLOW_CASES + SYNTH_CASES
OPTIONS = (("--width", {"type": int, "default": 64, "choices": (32, 64, 128, 256),
                        "help": "the student's width"}),
           ("--batch", {"type": int, "default": 32, "help": "utterances a call"}),
           ("--samples", {"type": int, "default": 64000, "help": "samples an utterance"}))


def facts():
    """{kernel entry: its ptxas -v lines} for the flow kernels of the working
    directory's tree, from a fresh build of its flow library."""
    sys.path.insert(0, os.getcwd())
    from nsynth_wavenet_tpu_torch.kernels import build

    build.BUILD_DIR = build.BUILD_DIR / f"facts-{os.getpid()}"
    try:
        _, report = build.build_all(["flow_kernel"])["flow_kernel"]
    finally:
        shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            entry = m.group(1)
        elif entry is not None and "flow_" in entry and re.search(r"registers|spill|smem", line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def one_pass(full, cases, width=64, batch=32, samples=64000):
    """Time ``cases`` in the tree of the working directory at the student's
    ``width``, ``batch`` utterances of ``samples`` samples; returns a dict."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk
    from nsynth_wavenet_tpu_torch.ops import stft

    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = batch
    pwn, params = cs.student_model(width=width)
    pwn32 = ParallelWavenet(dataclasses.replace(pwn.cfg, compute_dtype="float32"))
    ns, W = pwn.cfg.num_stages, pwn.cfg.width
    mel = stft.melspectrogram(torch.from_numpy(cs.synthetic_wavs(B, samples, 40 + B)).cuda())
    L = pwn.sample_length(mel.shape[1])
    out = {}
    if any(c in FLOW_CASES for c in cases):
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
        del x, enc, enc32, inputs
    for case, model in (("synth_bf16", pwn), ("synth_f32", pwn32)):
        if case in cases:
            out[case] = {"ms": cs.cuda_ms(lambda: parallelgen.synthesize_cuda(
                model, params, mel, torch.Generator().manual_seed(0)), reps=5)}
    return out


if __name__ == "__main__":
    sys.exit(ab_turns.main(__doc__, CASES, one_pass, facts, OPTIONS))
