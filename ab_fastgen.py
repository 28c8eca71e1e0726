"""Time the AR generation kernel of this tree against another tree's, in turns.

    python3 ab_fastgen.py --other <dir>          # e.g. an unpacked `git archive` of the parent
    python3 ab_fastgen.py --other <dir> --cases bf16_64,bf16_512

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
"""

import os
import sys

import ab_turns

CASES = ("bf16_64", "static_64", "row_64", "bf16_512", "static_512", "row_512", "static_896")


def one_pass(full, cases):
    """Time ``cases`` in the tree of the working directory; returns a dict."""
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
    sys.exit(ab_turns.main(__doc__, CASES, one_pass))
