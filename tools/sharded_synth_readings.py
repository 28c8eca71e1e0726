"""Readings behind chip_smoke.py M2's limits MESH_SYNTH_BINS_BF16 / _F32 (on
a card): synthesize_cuda of the full-width student (configs/parallel_wavenet.json)
at B = 8 x 1 s against the same call split as two ranks split it (rows 0-3
and 4-7, each with its rows of the B = 8 base noise, mesh.RowDraws), bf16
and f32, for several seeds of a random mel.  Prints, a seed a line, the
largest difference in quantisation bins (2 / quant_chann) and the share of
samples more than one bin apart.

    python3 tools/sharded_synth_readings.py [--seeds 8]

cuDNN's deterministic algorithms are on, as in M2: one call repeats itself
bit for bit, so what the lines show is the B = 4 calls against the B = 8
one."""

import argparse
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs.build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pwn, params = cs.student_model()
    pwn32 = cs.ParallelWavenet(dataclasses.replace(pwn.cfg, compute_dtype="float32"))
    bins = pwn.cfg.quant_chann / 2
    for seed in range(52, 52 + args.seeds):
        mel = torch.rand((8, 81, 80), generator=torch.Generator().manual_seed(seed)).cuda()
        out = {}
        for name, model in (("bf16", pwn), ("f32", pwn32)):
            with cs.deterministic_cudnn():
                one = cs.parallelgen.synthesize_cuda(model, params, mel,
                                                     torch.Generator().manual_seed(seed + 1))
                halves = [cs.parallelgen.synthesize_cuda(
                    model, params, mel[r0:r0 + 4],
                    cs.mesh_lib.RowDraws(torch.Generator().manual_seed(seed + 1), r0, 8))
                    for r0 in (0, 4)]
            d = (torch.cat(halves) - one).abs() * bins
            out[name] = f"max {float(d.max()):.1f} bins, {float((d > 1).float().mean()):.3f} over one"
        print(f"seed {seed}: bf16 {out['bf16']}; f32 {out['f32']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
