#!/usr/bin/env python3
"""The serving phase of ``chip_smoke.py``, this checkout against another.

    python3 torch_serve_ab.py OTHER_TREE [--rounds N]

Runs ``chip_smoke.py``'s ``build`` and ``serve`` phases, each run in a
fresh process, from ``OTHER_TREE`` (a checkout of another commit, for
example ``git archive <commit> | tar -x -C build/parent``) and from this
checkout in turns: other, this, this, other, repeated N times (default
2).  Prints one line a run and then one JSON object: tokens/s and the
decode-step median of every run, by tree, with the card's name and
power limit.  Serving is host-bound, so compare two trees only inside
one call of this script.  Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

PHASES = ("import chip_smoke; "
          "ctx = {'failures': [], 'smi': chip_smoke.smi_line()}; "
          "chip_smoke.phase_build(ctx); chip_smoke.phase_serve(ctx); "
          "raise SystemExit(1 if ctx['failures'] else 0)")


def serve_run(tree):
    """The serve phase's record from one fresh process in ``tree``."""
    out = subprocess.run([sys.executable, "-c", PHASES], cwd=tree,
                         capture_output=True, text=True, check=False)
    for line in out.stdout.splitlines():
        if line.startswith('{"phase": "serve"'):
            rec = json.loads(line)
            if out.returncode == 0 and rec["ok"]:
                return rec
    raise SystemExit(f"torch_serve_ab: {tree} failed:\n"
                     f"{out.stdout[-2000:]}{out.stderr[-2000:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": os.path.abspath(args.other),
             "this": os.path.dirname(os.path.abspath(__file__))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other") * args.rounds:
        rec = serve_run(trees[name])
        runs[name].append({"tokens_per_sec": rec["tokens_per_sec"],
                           "decode_step_ms_median":
                               rec["decode_step_ms_median"]})
        print(name, json.dumps(runs[name][-1]), flush=True)
    print(json.dumps({"card": smi, "trees": trees, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
