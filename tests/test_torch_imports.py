"""The PyTorch/CUDA port stands alone and defaults to the card.

- No file of ``tpu_mx_torch/``, nor the scripts that drive it on the card
  (``chip_smoke.py``, ``torch_serve_profile.py``,
  ``torch_train_profile.py``, ``torch_flash_ab.py``,
  ``torch_serve_ab.py``), imports jax or
  the reference package ``tpu_mx`` (AST scan, and a fresh interpreter's
  ``sys.modules`` after importing the port).
- No function of the port defaults ``device`` to the CPU; the entry
  points default to ``"cuda"``.
- ``chip_smoke.py`` alone, without the package, fails and prints no
  result.
"""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_mx_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "torch_serve_profile.py",
    ROOT / "torch_train_profile.py", ROOT / "torch_flash_ab.py",
    ROOT / "torch_serve_ab.py"]


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tpu_mx")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_no_port_function_defaults_device_to_cpu():
    offenders = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args
            pos = args.posonlyargs + args.args
            pairs = list(zip(pos[len(pos) - len(args.defaults):],
                             args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults) if d]
            for arg, default in pairs:
                if arg.arg == "device" and isinstance(default, ast.Constant) \
                        and str(default.value).startswith("cpu"):
                    offenders.append(f"{path.name}:{node.name}")
    assert not offenders


def test_entry_points_default_to_the_card():
    from tpu_mx_torch import device, random
    from tpu_mx_torch.models import BERTModel
    from tpu_mx_torch.parallel import CompiledTrainStep
    from tpu_mx_torch.serving import PagedKVCache, Server, TinyLM
    assert device.DEFAULT_DEVICE == "cuda"
    for fn in (TinyLM.__init__, TinyLM.from_numpy, Server.__init__,
               PagedKVCache.__init__, device.resolve, BERTModel.__init__,
               BERTModel.from_numpy, CompiledTrainStep.__init__,
               random.generator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_training_entry_points_refuse_the_cpu_unless_asked():
    """Without a card, ``BERTModel`` raises rather than build on the
    host, and ``CompiledTrainStep`` refuses a host network unless it is
    asked for the CPU; with ``device="cpu"`` both run."""
    import torch
    from tpu_mx_torch import MXNetError, optimizer
    from tpu_mx_torch.models import BERTModel, MLMLoss
    from tpu_mx_torch.parallel import CompiledTrainStep
    cfg = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
               vocab_size=50, max_length=16, dropout=0.0)
    net = BERTModel(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    opt = optimizer.create("lamb")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            BERTModel(cfg)
    with pytest.raises(MXNetError):
        CompiledTrainStep(net, MLMLoss(), opt)
    step = CompiledTrainStep(net, MLMLoss(), opt, device="cpu")
    tokens = torch.randint(0, 50, (2, 16), generator=torch.Generator()
                           .manual_seed(1))
    loss = step.step(tokens, torch.zeros_like(tokens), None,
                     torch.zeros((2, 3), dtype=torch.int64), tokens[:, :3])
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = ("import sys, tpu_mx_torch, tpu_mx_torch.serving, "
            "tpu_mx_torch.kernels, tpu_mx_torch.models, "
            "tpu_mx_torch.parallel, tpu_mx_torch.optimizer, "
            "tpu_mx_torch.gluon, tpu_mx_torch.rtc; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_mx')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
