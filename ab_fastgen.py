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

CASES = ("bf16_64", "static_64", "row_64", "bf16_512", "static_512", "row_512", "static_896")
PROBE_CASES = CASES[:-1]  # what --probe times when --cases is not given


def facts():
    """ab_turns.library_facts of the generation library of the working directory's tree."""
    return ab_turns.library_facts("fastgen_kernel")


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


def one_pass(full, cases):
    """Time ``cases`` in the tree of the working directory; returns a dict."""
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    cs, model, params, kws = _setup()
    out = {}
    for case in cases:
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
                           probe_cases=PROBE_CASES))
