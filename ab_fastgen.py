"""Time the AR generation kernel of this tree against another tree's, in turns.

    python3 ab_fastgen.py --other <dir>          # e.g. an unpacked `git archive` of the parent
    python3 ab_fastgen.py --other <dir> --cases bf16_64,bf16_512

Needs one CUDA card and the CUDA toolkit.  Runs four passes, each in a fresh
process whose working directory is a tree (other, this, this, other), so
each tree builds and loads its own kernel library.  A pass times one call of
chip_smoke.TIMED_STEPS steps (median of 5 by CUDA events) of the full-width
MoL teacher (configs/wavenet_mol.json, random weights from seed 0) in bf16,
W8A8 static (calibrated as chip_smoke.py calibrates) and W8A8 per-row, at
B = 64 and 512, and W8A8 static at B = 896 (or only the --cases named
<mode>_<B>); the first pass of this tree also
times the library yardstick (cuBLAS / torch._int_mm graph of one step's
products), the plain version and the card's bound (chip_smoke.time_kernel).
Each pass prints one line "AB <tree> <nvidia-smi name, power limit> <json>";
the last line is a JSON object with every pass and, per case, this tree's
time over the other's (median of its two passes each).
"""

import argparse
import json
import os
import subprocess
import sys

CASES = (("bf16", 64), ("static", 64), ("row", 64), ("bf16", 512), ("static", 512), ("row", 512),
         ("static", 896))


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
    for mode, B in cases:
        enc = cs.conditioning(model, params, B=B, L=cs.TIMED_STEPS, seed=10 + B)
        kw = kws[mode]
        if full:
            tm = cs.time_kernel(model.cfg, kw, enc, seed=1)
            out[f"{mode}_{B}"] = {k: tm[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                                                      "stream_bound_ms")}
        else:
            out[f"{mode}_{B}"] = {"ms": cs.cuda_ms(lambda: fk.generate(kw, enc, 1), reps=5)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--cases", default=",".join(f"{m}_{b}" for m, b in CASES),
                    help="comma-separated <mode>_<B> of " + ", ".join(f"{m}_{b}" for m, b in CASES))
    ap.add_argument("--pass", dest="one", choices=("plain", "full"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = [c for c in CASES if f"{c[0]}_{c[1]}" in args.cases.split(",")]
    if len(cases) != len(args.cases.split(",")):
        ap.error(f"--cases {args.cases}: want some of {[f'{m}_{b}' for m, b in CASES]}")
    if args.one:  # a child process: one pass in the working directory's tree
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"AB {os.getcwd()} {smi} {json.dumps(one_pass(args.one == 'full', cases))}", flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    here, other = os.path.dirname(os.path.abspath(__file__)), os.path.abspath(args.other)
    script = os.path.abspath(__file__)
    passes = []
    for label, tree, mode in (("other", other, "plain"), ("this", here, "full"),
                              ("this", here, "plain"), ("other", other, "plain")):
        res = subprocess.run([sys.executable, script, "--pass", mode, "--cases", args.cases], cwd=tree, capture_output=True,
                             text=True)
        sys.stderr.write(res.stderr[-4000:])
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode != 0 or not line:
            print(f"pass over {tree} failed (exit {res.returncode})", file=sys.stderr)
            return 1
        print(line[-1], flush=True)
        passes.append((label, json.loads(line[-1][line[-1].index("{"):])))
    ratio = {}
    for key in passes[0][1]:
        mine = sorted(p[key]["ms"] for lab, p in passes if lab == "this")
        theirs = sorted(p[key]["ms"] for lab, p in passes if lab == "other")
        ratio[key] = (mine[0] + mine[1]) / (theirs[0] + theirs[1])
    print(json.dumps({"passes": [{"tree": lab, **p} for lab, p in passes], "this_over_other": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
