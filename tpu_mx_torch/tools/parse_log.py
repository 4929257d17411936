"""Training-log parser; the port's copy of the reference's
``tools/parse_log.py``, with the same arguments, output and exit codes:
``Module.fit``/``Speedometer`` console logs (the port's
``tpu_mx_torch.callback.Speedometer`` and ``Module.fit`` write the
reference's format) into per-epoch accuracy/time tables.

    python tpu_mx_torch/tools/parse_log.py train.log                 # markdown table
    python tpu_mx_torch/tools/parse_log.py train.log --format csv
    python tpu_mx_torch/tools/parse_log.py train.log --format json   # machine-readable

Recognized lines (produced by callback.Speedometer and Module.fit /
model-zoo example loops):
    Epoch[3] Batch [40]  Speed: 1234.56 samples/sec  accuracy=0.912
    Epoch[3] Train-accuracy=0.931
    Epoch[3] Validation-accuracy=0.907
    Epoch[3] Time cost=12.345
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict

SPEED_RE = re.compile(
    r"Epoch\[(\d+)\]\s+Batch\s*\[(\d+)\]\s+Speed:\s*([\d.]+)\s*samples/sec")
TRAIN_RE = re.compile(r"Epoch\[(\d+)\]\s+Train-([\w.]+)=([-\d.eE]+)")
VAL_RE = re.compile(r"Epoch\[(\d+)\]\s+Validation-([\w.]+)=([-\d.eE]+)")
TIME_RE = re.compile(r"Epoch\[(\d+)\]\s+Time cost=([\d.]+)")


def parse(lines):
    """Returns a list of per-epoch dicts, epoch-ordered."""
    speeds = defaultdict(list)
    epochs = defaultdict(dict)
    for line in lines:
        m = SPEED_RE.search(line)
        if m:
            speeds[int(m.group(1))].append(float(m.group(3)))
            continue
        m = TRAIN_RE.search(line)
        if m:
            epochs[int(m.group(1))][f"train-{m.group(2)}"] = \
                float(m.group(3))
            continue
        m = VAL_RE.search(line)
        if m:
            epochs[int(m.group(1))][f"val-{m.group(2)}"] = float(m.group(3))
            continue
        m = TIME_RE.search(line)
        if m:
            epochs[int(m.group(1))]["time_s"] = float(m.group(2))
    for e, ss in speeds.items():
        epochs[e]["speed_mean"] = round(sum(ss) / len(ss), 2)
    return [dict(epoch=e, **epochs[e]) for e in sorted(epochs)]


def render(rows, fmt):
    if fmt == "json":
        return json.dumps(rows, indent=1)
    cols = ["epoch"]
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    if fmt == "csv":
        out = [",".join(cols)]
        out += [",".join(str(r.get(c, "")) for c in cols) for r in rows]
        return "\n".join(out)
    # markdown
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    out += ["| " + " | ".join(str(r.get(c, "")) for c in cols) + " |"
            for r in rows]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logfile", nargs="+")
    ap.add_argument("--format", choices=("markdown", "csv", "json"),
                    default="markdown")
    args = ap.parse_args(argv)
    lines = []
    for path in args.logfile:
        with open(path) as f:
            lines.extend(f)
    rows = parse(lines)
    if not rows:
        print("no recognized log lines found", file=sys.stderr)
        return 1
    print(render(rows, args.format))
    return 0


if __name__ == "__main__":
    sys.exit(main())
