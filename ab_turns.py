"""The runner of turns that the A/B timing scripts (ab_fastgen.py, ab_flow.py) share.

A script calls ``main(doc, cases, one_pass)``.  With ``--other <dir>`` it
runs four passes, each in a fresh process whose working directory is a tree
(other, this, this, other), so each tree builds and loads its own kernel
library; a pass runs the script again with ``--pass plain`` (the second:
``--pass full``) and calls ``one_pass(full, cases)`` in that tree, which
returns {case: {"ms": ..., ...}}.  Each pass prints one line
"AB <tree> <nvidia-smi name, power limit> <json>"; the last line is a JSON
object with every pass and, per case, this tree's time over the other's (the
sum of its two passes over the other's two; cases without a time are left
out) and, for a case that returns a digest of its output ("sha"), whether
every pass of both trees gave the same one (same_output).  ``facts``, where a script
gives it, is run once in each tree (other, then this) by ``--facts``
instead, and its dict printed on the same kind of line; the last line then
says, entry by entry, whether the two trees' facts are equal, and which
entries one tree has and the other lacks (``library_facts`` gives
libraries' compiler reports and a digest of each kernel's machine code).  ``probe``, where a script gives it, runs by
``--probe`` in this tree alone: it times the full call and each perf probe
of the kernel in turns, rep by rep (``interleaved``), and prints one line
"PROBE <nvidia-smi name, power limit> <json>".
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys


def smi():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def interleaved(calls, reps):
    """Time each of ``calls`` ({name: fn}, the full call first) once a rep, in
    turns, for ``reps`` reps, by CUDA events, after one warm-up call each.
    Returns {name: {"ms": median, "min_ms", "max_ms", "minus_full_ms": the
    median over reps of (this call - the full call of the same rep),
    "share_of_full": that over the full call's median}}."""
    import numpy as np
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    full = times[next(iter(calls))]
    out = {}
    for name, t in times.items():
        minus = float(np.median([a - b for a, b in zip(t, full)]))
        out[name] = {"ms": float(np.median(t)), "min_ms": min(t), "max_ms": max(t),
                     "minus_full_ms": minus, "share_of_full": minus / float(np.median(full))}
    return out


def _entry(name):
    """A kernel entry's mangled name as two trees can compare it: without the
    hash that names its anonymous namespace (it differs between trees), and
    without the probe template argument that a serving instantiation
    carries as 0 (PROBE_NONE), so that trees before and after it match."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", name)
    return re.sub(r"(I(?:Li-?\d+E){2})Li0EE", r"\1E", name)


def library_facts(*names):
    """{"<library>/<kernel entry>": {"ptxas": its lines of the compiler's
    resource report (registers, spill bytes, shared memory), "sass": a digest
    of its machine code and its instruction count}} of the libraries
    ``names`` of the working directory's tree, from a fresh build, one nvcc a
    library, all at once (cuobjdump -sass beside nvcc; the instruction
    addresses are left out of the digest)."""
    sys.path.insert(0, os.getcwd())
    from nsynth_wavenet_tpu_torch.kernels import build

    build.BUILD_DIR = build.BUILD_DIR / f"facts-{os.getpid()}"
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    try:
        built = build.build_all(names)
        sass = {name: subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                     text=True, check=True).stdout
                for name, (path, _) in built.items()}
    finally:
        shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    out = {}
    for name, (_, report) in built.items():
        entry = None
        for line in report.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
            if m:
                entry = f"{name}/{_entry(m.group(1))}"
            elif entry is not None and re.search(r"registers|spill|smem", line):
                out.setdefault(entry, {"ptxas": []})["ptxas"].append(line.split(":", 1)[-1].strip())
        code, entry = {}, None
        for line in sass[name].splitlines():
            m = re.match(r"\s*Function : (\w+)", line)
            if m:
                entry = f"{name}/{_entry(m.group(1))}"
                code[entry] = []
            elif entry is not None and re.search(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", line):
                code[entry].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
        for entry, lines in code.items():
            digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
            out.setdefault(entry, {"ptxas": []})["sass"] = f"{digest} ({len(lines)} lines)"
    return out


def run_pass(tree, mode, cases, forward=()):
    """One pass of the calling script in ``tree`` (``forward``: the script's own
    options, passed on); returns its dict, or None."""
    res = subprocess.run([sys.executable, os.path.abspath(sys.argv[0]), "--pass", mode,
                          "--cases", ",".join(cases), *forward], cwd=tree, capture_output=True,
                         text=True)
    sys.stderr.write(res.stderr[-4000:])
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not line:
        print(f"pass over {tree} failed (exit {res.returncode})", file=sys.stderr)
        return None
    print(line[-1], flush=True)
    return json.loads(line[-1][line[-1].index("{"):])


def main(doc, cases, one_pass, facts=None, options=(), probe=None, probe_cases=None,
         default_cases=None):
    """``options``: the script's own (flag, argparse keywords) pairs; their
    values go to ``one_pass`` (and ``probe``) as keywords and to every pass's
    process.  ``probe_cases``: the cases --probe times when --cases is not
    given; ``default_cases``: those a run times then (default: all)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    for flag, kw in options:
        ap.add_argument(flag, **kw)
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--cases", help="comma-separated of " + ", ".join(cases))
    if facts is not None:
        ap.add_argument("--facts", action="store_true", help="run the facts pass in both trees")
    if probe is not None:
        ap.add_argument("--probe", action="store_true",
                        help="time the full call and each perf probe in turns, in this tree")
    ap.add_argument("--pass", dest="one", choices=("plain", "full", "facts"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cases is None:
        args.cases = ",".join(probe_cases if getattr(args, "probe", False) and probe_cases
                              else default_cases or cases)
    chosen = [c for c in args.cases.split(",") if c]
    opts = {flag[2:]: getattr(args, flag[2:]) for flag, _ in options}
    forward = [str(v) for flag, _ in options for v in (flag, opts[flag[2:]])]
    if not chosen or any(c not in cases for c in chosen):
        ap.error(f"--cases {args.cases}: want some of {', '.join(cases)}")
    if args.one:  # a child process: one pass in the working directory's tree
        # that tree's package first: the script's own directory leads sys.path
        sys.path.insert(0, os.getcwd())
        res = facts() if args.one == "facts" else one_pass(args.one == "full", chosen, **opts)
        print(f"AB {os.getcwd()} {smi()} {json.dumps(res)}", flush=True)
        return 0
    if getattr(args, "probe", False):
        print(f"PROBE {smi()} {json.dumps(probe(chosen, **opts))}", flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    here = os.path.dirname(os.path.abspath(sys.argv[0]))
    other = os.path.abspath(args.other)
    if getattr(args, "facts", False):
        both = [run_pass(tree, "facts", chosen, forward) for tree in (other, here)]
        if None in both:
            return 1
        shared = sorted(set(both[0]) & set(both[1]))
        print(json.dumps({"facts_equal": {k: both[0][k] == both[1][k] for k in shared},
                          "only_other": sorted(set(both[0]) - set(both[1])),
                          "only_this": sorted(set(both[1]) - set(both[0]))}))
        return 0
    passes = []
    for label, tree, mode in (("other", other, "plain"), ("this", here, "full"),
                              ("this", here, "plain"), ("other", other, "plain")):
        res = run_pass(tree, mode, chosen, forward)
        if res is None:
            return 1
        passes.append((label, res))
    ratio, same = {}, {}
    for key, first in passes[0][1].items():
        if "ms" in first:
            mine = sum(p[key]["ms"] for lab, p in passes if lab == "this")
            theirs = sum(p[key]["ms"] for lab, p in passes if lab == "other")
            ratio[key] = mine / theirs
        if "sha" in first:  # a digest of the case's output: equal in every pass of both trees?
            same[key] = len({json.dumps(p[key]["sha"], sort_keys=True) for _, p in passes}) == 1
    print(json.dumps({"passes": [{"tree": lab, **p} for lab, p in passes],
                      "this_over_other": ratio, "same_output": same}))
    return 0
