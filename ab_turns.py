"""The runner of turns that the A/B timing scripts (ab_fastgen.py, ab_flow.py) share.

A script calls ``main(doc, cases, one_pass)``.  With ``--other <dir>`` it
runs four passes, each in a fresh process whose working directory is a tree
(other, this, this, other), so each tree builds and loads its own kernel
library; a pass runs the script again with ``--pass plain`` (the second:
``--pass full``) and calls ``one_pass(full, cases)`` in that tree, which
returns {case: {"ms": ..., ...}}.  Each pass prints one line
"AB <tree> <nvidia-smi name, power limit> <json>"; the last line is a JSON
object with every pass and, per case, this tree's time over the other's (the
sum of its two passes over the other's two).  ``facts``, where a script
gives it, is run once in each tree (other, then this) by ``--facts``
instead, and its dict printed on the same kind of line.
"""

import argparse
import json
import os
import subprocess
import sys


def smi():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


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


def main(doc, cases, one_pass, facts=None, options=()):
    """``options``: the script's own (flag, argparse keywords) pairs; their
    values go to ``one_pass`` as keywords and to every pass's process."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    for flag, kw in options:
        ap.add_argument(flag, **kw)
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--cases", default=",".join(cases), help="comma-separated of " + ", ".join(cases))
    if facts is not None:
        ap.add_argument("--facts", action="store_true", help="run the facts pass in both trees")
    ap.add_argument("--pass", dest="one", choices=("plain", "full", "facts"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    chosen = [c for c in args.cases.split(",") if c]
    opts = {flag[2:]: getattr(args, flag[2:]) for flag, _ in options}
    forward = [str(v) for flag, _ in options for v in (flag, opts[flag[2:]])]
    if not chosen or any(c not in cases for c in chosen):
        ap.error(f"--cases {args.cases}: want some of {', '.join(cases)}")
    if args.one:  # a child process: one pass in the working directory's tree
        res = facts() if args.one == "facts" else one_pass(args.one == "full", chosen, **opts)
        print(f"AB {os.getcwd()} {smi()} {json.dumps(res)}", flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    here = os.path.dirname(os.path.abspath(sys.argv[0]))
    other = os.path.abspath(args.other)
    if getattr(args, "facts", False):
        return 0 if all(run_pass(tree, "facts", chosen, forward) is not None
                        for tree in (other, here)) else 1
    passes = []
    for label, tree, mode in (("other", other, "plain"), ("this", here, "full"),
                              ("this", here, "plain"), ("other", other, "plain")):
        res = run_pass(tree, mode, chosen, forward)
        if res is None:
            return 1
        passes.append((label, res))
    ratio = {}
    for key in passes[0][1]:
        mine = sum(p[key]["ms"] for lab, p in passes if lab == "this")
        theirs = sum(p[key]["ms"] for lab, p in passes if lab == "other")
        ratio[key] = mine / theirs
    print(json.dumps({"passes": [{"tree": lab, **p} for lab, p in passes],
                      "this_over_other": ratio}))
    return 0
