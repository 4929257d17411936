"""The port's command-line tools (``tpu_mx_torch/tools``) against the
reference's (``tools/``), on the same inputs, on the CPU.

- ``im2rec``: the ``.lst``, ``.rec`` and ``.idx`` files of the port's tool
  are byte-equal to the reference tool's, on the Python path and with
  ``--native``;
- ``telemetry_report``, ``blackbox_report``, ``slo_report`` and
  ``capacity_report``: each tool of either package, run as a script,
  prints the same text and exits with the same code on documents the
  port wrote (a serving black box and telemetry with its windows, a
  capacity ledger and its forensics, a telemetry file with ``fusion.*``
  and ``kvstore.*`` series), on a broken one and on an unreadable one;
  and, run as a script, the port's imports neither torch nor jax.  The
  port's metric catalog is the reference's and a few names more
  (:func:`port_only_metrics`): ``--validate`` compares on the document
  without those records, and on the document as written the reference
  refuses exactly those names;
- ``parse_log``: both tools tabulate a log written by the port's
  ``Module.fit`` and ``Speedometer`` alike.
"""
import json
import logging
import os
import runpy
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tpu_mx import telemetry as jtelemetry

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, engine, nd, telemetry, tracing
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.serving import Server, TinyLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=64, embed_dim=64, num_heads=2, num_layers=2)
PROMPTS = ([5, 6, 7], [9, 2], [1] * 7, [3, 14, 15, 9, 2, 6, 5, 3, 5] * 2)


def _script(package, tool):
    return os.path.join(REPO, "tools", f"{tool}.py") \
        if package == "reference" else \
        os.path.join(REPO, "tpu_mx_torch", "tools", f"{tool}.py")


def run_tool(package, tool, *args, cwd):
    """``(exit code, stdout, stderr)`` of ``python <tool>.py args``, from
    a probe that fails unless the run left torch and jax unimported."""
    script = _script(package, tool)
    probe = ("import runpy, sys; sys.argv = %r; code = 0\n"
             "try:\n    runpy.run_path(%r, run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code\n"
             "bad = sorted(m for m in ('torch', 'jax', 'tpu_mx', "
             "'tpu_mx_torch') if m in sys.modules)\n"
             "assert not bad, bad\nsys.exit(code)"
             % ([script, *map(str, args)], script))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, cwd=str(cwd))
    return r.returncode, r.stdout, r.stderr


def assert_same_run(tool, *args, cwd, code=0):
    """Both packages' tool: the same exit code (``code``) and text."""
    ref = run_tool("reference", tool, *args, cwd=cwd)
    port = run_tool("port", tool, *args, cwd=cwd)
    assert "AssertionError" not in port[2], port[2][-2000:]
    assert port[0] == ref[0] == code, (ref, port)
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    return port


def port_only_metrics():
    """The metric names the port's catalog has and the reference's has
    not (the port's own counters: its dense prefill arm, its RNN arm, its
    mesh's host staging)."""
    return set(telemetry.KNOWN_METRICS) - set(jtelemetry.KNOWN_METRICS)


def shared_catalog(path, out):
    """A copy of a telemetry JSONL file or a black box at ``out`` without
    the records of :func:`port_only_metrics`."""
    extra = port_only_metrics()
    text = Path(path).read_text()
    if str(path).endswith(".jsonl"):
        keep = [line for line in text.splitlines()
                if json.loads(line)["name"] not in extra]
        out.write_text("\n".join(keep) + "\n")
    else:
        doc = json.loads(text)
        doc["telemetry"] = [r for r in doc["telemetry"]
                            if r["name"] not in extra]
        out.write_text(json.dumps(doc))
    return out


def assert_reference_refuses_only_port_metrics(tool, *args, cwd):
    """On a document with port-only metrics: the port's tool validates
    it, the reference's fails naming those metrics and nothing else."""
    ref = run_tool("reference", tool, *args, cwd=cwd)
    port = run_tool("port", tool, *args, cwd=cwd)
    assert port[0] == 0, port[2][-2000:]
    assert ref[0] == 1
    errors = ref[2].splitlines()[1:]
    assert errors and all(any(repr(m) in e for m in port_only_metrics())
                          for e in errors), ref[2][-2000:]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("TPUMX_SPECULATIVE", "TPUMX_PREFIX_SHARING",
                 "TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE", "TPUMX_CHAOS",
                 "TPUMX_TELEMETRY"):
        monkeypatch.delenv(name, raising=False)
    telemetry.reset()
    tracing.reset()
    yield
    telemetry.reset()
    tracing.reset()


# ---------------------------------------------------------------------------
# im2rec
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two class folders of small JPEGs (and one stray file)."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(3)
    for c, n in (("cat", 4), ("dog", 5)):
        (root / c).mkdir()
        for i in range(n):
            img = cv2.GaussianBlur(
                rng.randint(0, 256, (30 + 3 * i, 40, 3)).astype(np.uint8),
                (5, 5), 0)
            cv2.imwrite(str(root / c / f"{i}.jpg"), img)
        (root / c / "notes.txt").write_text("not an image")
    return root


def _im2rec(package, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["im2rec.py", *map(str, argv)])
    if package == "reference":
        runpy.run_path(_script("reference", "im2rec"), run_name="__main__")
    else:
        runpy.run_module("tpu_mx_torch.tools.im2rec", run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("resize", [0, 24])
def test_im2rec_files_are_the_reference_tools_bytes(
        tmp_path, image_dir, monkeypatch, capsys, native, resize):
    outs = {}
    for package in ("reference", "port"):
        out = tmp_path / package
        out.mkdir()
        prefix = out / "set"
        said = _im2rec(package, ["--list", "--shuffle", "--seed", "7",
                                 prefix, image_dir], monkeypatch, capsys)
        assert said == f"wrote {prefix}.lst: 9 images, 2 classes\n"
        argv = ["--resize", resize, "--quality", 90, prefix, image_dir]
        if native:
            argv = ["--native", "--num-thread", 3] + argv
        said = _im2rec(package, argv, monkeypatch, capsys)
        outs[package] = [said.replace(str(out), "OUT")] + [
            (out / f"set{ext}").read_bytes()
            for ext in (".lst", ".rec", ".idx")]
    assert outs["port"] == outs["reference"]
    # the records read back through the port's reader, labels and sizes
    from tpu_mx_torch import recordio
    lines = outs["port"][1].decode().splitlines()
    r = recordio.MXIndexedRecordIO(str(tmp_path / "port" / "set.idx"),
                                   str(tmp_path / "port" / "set.rec"), "r")
    for line in lines:
        idx, label, rel = line.split("\t")
        header, img = recordio.unpack_img(r.read_idx(int(idx)))
        assert header.label == float(label) == float(rel.startswith("dog"))
        if resize:
            assert min(img.shape[:2]) == resize
    r.close()


def test_im2rec_without_a_list_exits_as_the_reference(tmp_path, image_dir):
    for package in ("reference", "port"):
        cmd = ([sys.executable, _script(package, "im2rec")]
               if package == "reference" else
               [sys.executable, "-m", "tpu_mx_torch.tools.im2rec"])
        r = subprocess.run(cmd + [str(tmp_path / "none"), str(image_dir)],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO)
        assert r.returncode == 1
        assert r.stderr.strip().endswith(
            f"{tmp_path / 'none'}.lst not found — run --list first")


# ---------------------------------------------------------------------------
# the report tools, on documents the port wrote
# ---------------------------------------------------------------------------
def _server(**kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    return Server(TinyLM(**SMALL, seed=0, device="cpu"), device="cpu", **kw)


@pytest.fixture
def serve_docs(tmp_path):
    """A serving run's black box (a restart storm, the SLO monitor on)
    and its telemetry snapshots, with the windows."""
    box = str(tmp_path / "serve")
    srv = _server(backoff=0.0, blackbox=box, slo=True)
    reqs = [srv.submit(p, 8, request_id=f"r{i}")
            for i, p in enumerate(PROMPTS)]
    srv.step()
    metrics = tmp_path / "serve.jsonl"
    telemetry.flush(str(metrics))
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    telemetry.flush(str(metrics))
    return Path(tracing.blackbox_path(box)), metrics


@pytest.fixture
def capacity_docs(tmp_path):
    """A run that exhausts an undersized pool under two tenants: the
    capacity forensics and the telemetry with the pool gauges."""
    prefix = str(tmp_path / "cap")
    srv = _server(num_blocks=6, block_size=4, max_tokens=10 ** 6,
                  blackbox=prefix, prefix_sharing=True,
                  tenants={"a": {"weight": 1.0}, "b": {"weight": 1.0}})
    metrics = tmp_path / "cap.jsonl"
    reqs = [srv.submit([1, 2, 3, 4, 5, 6, 7], 8,
                       tenant="a" if i % 2 else "b") for i in range(5)]
    for _ in range(3):
        srv.step()
        telemetry.flush(str(metrics))
    srv.run_until_idle()
    telemetry.flush(str(metrics))
    assert all(r.state == "done" for r in reqs)
    forensics = srv.engine.cache.flush_forensics()
    assert forensics == prefix + "-capacity.json"
    return Path(forensics), metrics


@pytest.fixture
def engine_metrics(tmp_path):
    """Two telemetry snapshots of fused imperative ops and kvstore
    traffic: ``fusion.*`` and ``kvstore.*`` series."""
    paths = []
    with mx.cpu():
        x = nd.array(np.linspace(-1, 1, 16, dtype=np.float32).reshape(4, 4))
        store = mx.kv.create("device")
        store.init(0, nd.zeros((4, 4)))
        for k in range(2):
            with autograd.record(), engine.bulk(16):
                y = nd.tanh(nd.sin(x) * 0.5) + k
            y.asnumpy()
            store.push(0, y)
            out = nd.zeros((4, 4))
            store.pull(0, out=out)
            path = tmp_path / f"engine{k}.jsonl"
            telemetry.flush(str(path))
            paths.append(path)
    names = {json.loads(line)["name"] for line in
             paths[-1].read_text().splitlines()}
    assert {"fusion.flushes", "kvstore.pushes", "kvstore.pulls"} <= names
    return paths


@pytest.mark.parametrize("validate", [False, True], ids=["render", "validate"])
def test_blackbox_report_equals_the_reference(tmp_path, serve_docs,
                                              validate):
    box, _ = serve_docs
    if validate:
        assert_reference_refuses_only_port_metrics(
            "blackbox_report", box, "--validate", cwd=tmp_path)
        box = shared_catalog(box, tmp_path / "shared-blackbox.json")
    args = [box] + (["--validate"] if validate else [])
    _, out, _ = assert_same_run("blackbox_report", *args, cwd=tmp_path)
    assert "Recovery chains" in out
    if validate:
        assert "schema OK" in out


def test_slo_report_equals_the_reference(tmp_path, serve_docs):
    box, metrics = serve_docs
    assert_reference_refuses_only_port_metrics(
        "slo_report", metrics, "--box", box, "--validate", cwd=tmp_path)
    assert_same_run("slo_report", metrics, "--slo", "itl_p50 < 2s",
                    "--top", 2, cwd=tmp_path)
    box = shared_catalog(box, tmp_path / "shared-blackbox.json")
    metrics = shared_catalog(metrics, tmp_path / "shared.jsonl")
    _, out, _ = assert_same_run("slo_report", metrics, "--box", box,
                                "--validate", cwd=tmp_path)
    assert "schema OK" in out and "request timeline(s)" in out


def test_capacity_report_equals_the_reference(tmp_path, capacity_docs):
    forensics, metrics = capacity_docs
    assert_reference_refuses_only_port_metrics(
        "capacity_report", metrics, "--forensics", forensics, "--validate",
        cwd=tmp_path)
    metrics = shared_catalog(metrics, tmp_path / "shared.jsonl")
    _, out, _ = assert_same_run("capacity_report", metrics, "--forensics",
                                forensics, "--validate", cwd=tmp_path)
    assert "schema OK" in out and "forensic record(s)" in out


@pytest.mark.parametrize("mode", ["render", "validate", "diff", "merge"])
def test_telemetry_report_equals_the_reference(tmp_path, engine_metrics,
                                               mode):
    a, b = engine_metrics
    args = {"render": [b],
            "validate": [b, "--validate", "--require",
                         "fusion.flushes,kvstore.pushes,kvstore.pulls"],
            "diff": ["--diff", a, b],
            "merge": ["--merge", a, b, "--validate"]}[mode]
    _, out, _ = assert_same_run("telemetry_report", *args, cwd=tmp_path)
    assert "fusion.flushes" in out and "kvstore.pushes" in out


@pytest.mark.parametrize("tool", ["blackbox_report", "slo_report",
                                  "capacity_report", "telemetry_report"])
def test_report_tools_refuse_broken_and_unreadable_files_alike(
        tmp_path, serve_docs, tool):
    """Exit code 1 for a document that fails validation, 2 for one that
    cannot be read, with the same words in both packages."""
    box = shared_catalog(serve_docs[0], tmp_path / "shared-blackbox.json")
    metrics = shared_catalog(serve_docs[1], tmp_path / "shared.jsonl")
    doc = json.loads(box.read_text())
    if tool == "blackbox_report":
        doc["events"][0]["event"] = "no.such_event"
        broken = tmp_path / "broken.json"
        broken.write_text(json.dumps(doc))
        args = [broken, "--validate"]
    else:
        lines = metrics.read_text().splitlines()
        rec = json.loads(lines[-1])
        rec["name"] = "no.such_metric"
        broken = tmp_path / "broken.jsonl"
        broken.write_text("\n".join(lines + [json.dumps(rec)]) + "\n")
        args = [broken, "--validate"]
    assert_same_run(tool, *args, cwd=tmp_path, code=1)
    missing = tmp_path / "missing.json"
    if tool != "telemetry_report":
        assert_same_run(tool, missing, cwd=tmp_path, code=2)
        return
    # the reference's telemetry_report has no exit code for a file it
    # cannot open: both raise, with the same words
    ref = run_tool("reference", tool, missing, cwd=tmp_path)
    port = run_tool("port", tool, missing, cwd=tmp_path)
    assert port[0] == ref[0] == 1
    assert port[2].splitlines()[-1] == ref[2].splitlines()[-1]
    assert "FileNotFoundError" in port[2].splitlines()[-1]


# ---------------------------------------------------------------------------
# parse_log
# ---------------------------------------------------------------------------
@pytest.fixture
def fit_log(tmp_path):
    """The log of a two-epoch ``Module.fit`` with a ``Speedometer``."""
    path = tmp_path / "train.log"
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        with mx.cpu():
            rng = np.random.RandomState(0)
            x = rng.randn(64, 10).astype(np.float32)
            y = (x[:, 0] > 0).astype(np.float32)
            data = mx.sym.Variable("data")
            fc = mx.sym.FullyConnected(data, num_hidden=2, name="fc")
            net = mx.sym.SoftmaxOutput(fc, mx.sym.Variable("softmax_label"),
                                       name="softmax")
            mod = mx.module.Module(net, context=mx.cpu())
            it = mx.io.NDArrayIter(x, y, batch_size=8,
                                   label_name="softmax_label")
            val = mx.io.NDArrayIter(x, y, batch_size=8,
                                    label_name="softmax_label")
            mod.fit(it, eval_data=val, num_epoch=2, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1},
                    initializer=mx.init.Xavier(), eval_metric="acc",
                    batch_end_callback=mx.callback.Speedometer(8, 2))
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()
    return path


@pytest.mark.parametrize("fmt", ["markdown", "csv", "json"])
def test_parse_log_of_a_port_training_log_equals_the_reference(
        tmp_path, fit_log, fmt):
    _, out, _ = assert_same_run("parse_log", fit_log, "--format", fmt,
                                cwd=tmp_path)
    if fmt == "json":
        rows = json.loads(out)
        assert [r["epoch"] for r in rows] == [0, 1]
        for r in rows:
            assert {"train-accuracy", "val-accuracy", "time_s",
                    "speed_mean"} <= set(r)
    empty = tmp_path / "empty.log"
    empty.write_text("")
    assert_same_run("parse_log", empty, cwd=tmp_path, code=1)
