"""The port's multi-rank dry run, from the reference's
``__graft_entry__.dryrun_multichip``: one step of each parallel path on
a mesh of ``n`` ranks at tiny shapes.

    python -m tpu_mx_torch.tools.launch -n 4 \\
        python -m tpu_mx_torch.tools.dryrun_multichip

Each rank joins the launcher's ``gloo`` group at
``import tpu_mx_torch`` and computes on its current card
(``torch.cuda.current_device()``; ``--cpu``: the host).  The phases,
with the reference's mesh factoring and sizes:

1. one BERT step (2 layers, 32 units, 4 heads, vocabulary 96) on a
   dp×sp×tp mesh (tp = 2 when n is even, sp = 2 when 4 divides n) with
   ``bert_sharding_rules``, ``bert_data_specs`` and LAMB: ring attention
   over ``sp``, Megatron layers over ``tp``;
2. one GPipe step (``pipeline_apply``) on a dp×pp mesh;
3. one step of a Dense stack with ``fsdp_rules`` over ``dp = n``;
4. an fp8-compressed ``dp = n`` step under ``accum_steps=2``;
5. one BERT step with Ulysses attention on a dp×sp mesh (``sp = 2``),
   the dispatch counter showing the Ulysses arm;
6. one step of an ``MoEFFN`` net with ``moe_sharding_rules`` on a
   dp×ep mesh (``ep = 2``).

The reference's elastic failure-injection phase is the launcher's own
test (``--supervise``), not repeated here.  Every rank prints its lines;
a phase that fails raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dryrun_multichip", "main"]


def _print(rank, msg):
    if rank == 0:
        print(msg, flush=True)


def _bert_cfg():
    from tpu_mx_torch.models.bert import bert_base_config
    cfg = bert_base_config(vocab_size=96, max_len=64)
    cfg.update(num_layers=2, units=32, hidden_size=64, num_heads=4,
               dropout=0.0)
    return cfg


def _bert_step(mesh, batch, seq, rules, device, seed=0):
    """One LAMB step of the dry run's BERT on ``mesh``; returns the loss."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.models.bert import BERTModel, bert_data_specs
    from tpu_mx_torch.parallel import CompiledTrainStep
    rng = np.random.RandomState(seed)
    net = BERTModel(_bert_cfg(), mesh=mesh, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    step = CompiledTrainStep(
        net, gloss.SoftmaxCrossEntropyLoss(),
        optimizer.create("lamb", learning_rate=1e-3), mesh=mesh,
        rules=rules, data_specs=bert_data_specs(), device=device)
    tokens = torch.tensor(rng.randint(0, 96, (batch, seq)), device=device)
    types = torch.zeros((batch, seq), dtype=torch.int64, device=device)
    labels = torch.tensor(rng.randint(0, 96, (batch, seq)),
                          dtype=torch.float32, device=device)
    return float(step.step(tokens, types, labels))


def _dense_net(widths, seed, device):
    from tpu_mx_torch.gluon import nn
    g = torch.Generator(device).manual_seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(widths[1], in_units=widths[0], activation="relu",
                     generator=g),
            nn.Dense(widths[2], in_units=widths[1], generator=g))
    net.initialize(init="xavier", generator=g)
    return net


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the phases on every rank of a process group of ``n_devices``
    ranks, on ``device`` (default: the current context's); returns
    ``{phase: loss}``."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == n_devices):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): run it on {n_devices} ranks: "
            f"python -m tpu_mx_torch.tools.launch -n {n_devices} python -m "
            "tpu_mx_torch.tools.dryrun_multichip")
    from tpu_mx_torch import device as _device
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.models.bert import bert_sharding_rules
    from tpu_mx_torch.parallel import (CompiledTrainStep, MoEFFN, P,
                                       dispatch_counts, fsdp_rules,
                                       make_mesh, moe_sharding_rules,
                                       pipeline_apply, set_sp_strategy,
                                       stack_stage_params)
    dev = _device.resolve(device)
    rank = dist.get_rank()
    n = n_devices
    losses = {}

    # phase 1: BERT on dp x sp x tp
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    dp = n // (tp * sp)
    mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp})
    losses["bert"] = _bert_step(mesh, 2 * dp, 16 * sp, bert_sharding_rules(),
                                dev)
    _print(rank, f"dryrun_multichip({n}): mesh dp={dp} sp={sp} tp={tp}, one "
                 f"step done, loss={losses['bert']:.4f}")

    # phase 2: GPipe on dp x pp
    pp = 2 if n % 2 == 0 else 1
    dp2 = n // pp
    mesh2 = make_mesh({"dp": dp2, "pp": pp})
    rng = np.random.RandomState(0)
    d, m = 8, 4
    stacked = stack_stage_params([
        {"w": torch.tensor(rng.randn(d, d) * 0.3, dtype=torch.float32,
                           device=dev),
         "b": torch.zeros(d, device=dev)} for _ in range(pp)])
    for a in stacked.values():
        a.requires_grad_()
    xb = torch.tensor(rng.randn(m * dp2, d), dtype=torch.float32, device=dev)
    tb = torch.tensor(rng.randn(m * dp2, d) * 0.1, dtype=torch.float32,
                      device=dev)
    y = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), stacked,
                       xb, mesh2, num_microbatches=m, data_spec=P("dp"))
    loss = ((y - tb) ** 2).mean()
    grads = torch.autograd.grad(loss, list(stacked.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    losses["pipeline"] = float(loss.detach())
    _print(rank, f"dryrun_multichip({n}): pipeline mesh dp={dp2} pp={pp}, "
                 f"one GPipe step done, loss={losses['pipeline']:.4f}")

    # phase 3: FSDP over dp = n
    mesh3 = make_mesh({"dp": n})
    fnet = _dense_net((16, 64, 8), 7, dev)
    rules = fsdp_rules(dict(fnet.named_parameters()), min_size=256,
                       axis_size=n)
    fstep = CompiledTrainStep(fnet, gloss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1),
                              mesh=mesh3, rules=rules, device=dev)
    rng = np.random.RandomState(7)
    fx = torch.tensor(rng.rand(2 * n, 16), dtype=torch.float32, device=dev)
    fy = torch.tensor(rng.randint(0, 8, (2 * n,)), dtype=torch.float32,
                      device=dev)
    losses["fsdp"] = float(fstep.step(fx, fy))
    _print(rank, f"dryrun_multichip({n}): fsdp mesh dp={n}, {len(rules)} "
                 f"sharded params, one step done, "
                 f"loss={losses['fsdp']:.4f}")

    # phase 4: fp8-compressed dp reduction x accumulation
    cnet = _dense_net((16, 32, 8), 11, dev)
    cstep = CompiledTrainStep(cnet, gloss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1),
                              mesh=mesh3, gradient_compression={"type": "fp8"},
                              accum_steps=2, device=dev)
    rng = np.random.RandomState(11)
    for _ in range(2):
        cx = torch.tensor(rng.rand(2 * n, 16), dtype=torch.float32,
                          device=dev)
        cy = torch.tensor(rng.randint(0, 8, (2 * n,)), dtype=torch.float32,
                          device=dev)
        cl = cstep.step(cx, cy)
    assert cstep._t == 1
    losses["compressed"] = float(cl)
    _print(rank, f"dryrun_multichip({n}): compressed mesh dp={n}, fp8 psum "
                 "x accum_steps=2, one applied update, "
                 f"loss={losses['compressed']:.4f}")

    # phase 5: Ulysses on dp x sp
    usp = 2 if n % 2 == 0 else 1
    if usp > 1:
        umesh = make_mesh({"dp": n // usp, "sp": usp})
        prev = set_sp_strategy("ulysses")
        before = dispatch_counts["ulysses"]
        try:
            losses["ulysses"] = _bert_step(umesh, 2 * (n // usp), 16 * usp,
                                           None, dev, seed=1)
        finally:
            set_sp_strategy(prev)
        assert np.isfinite(losses["ulysses"])
        assert dispatch_counts["ulysses"] > before, dispatch_counts
        _print(rank, f"dryrun_multichip({n}): ulysses mesh dp={n // usp} "
                     f"sp={usp}, one step done, "
                     f"loss={losses['ulysses']:.4f}")

    # phase 6: MoE experts over ep
    ep = 2 if n % 2 == 0 else 1
    if ep > 1:
        emesh = make_mesh({"dp": n // ep, "ep": ep})
        g = torch.Generator(dev).manual_seed(13)

        class MoENet(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.moe = MoEFFN(16, 32, 4, top_k=2, generator=g)

            def forward(self, x, target):
                y, aux = self.moe(x)
                return ((y - target) ** 2).mean() + 0.01 * aux

        enet = MoENet().to(dev)
        enet.moe.initialize(init="xavier", generator=g)
        estep = CompiledTrainStep(
            enet, gloss.PassThrough(),
            optimizer.create("adam", learning_rate=1e-3), mesh=emesh,
            rules=moe_sharding_rules(), data_specs=(P("dp"), P("dp"), P()),
            device=dev)
        rng = np.random.RandomState(13)
        ex = torch.tensor(rng.randn(2 * (n // ep), 8, 16),
                          dtype=torch.float32, device=dev)
        et = torch.tensor(rng.randn(2 * (n // ep), 8, 16) * 0.1,
                          dtype=torch.float32, device=dev)
        losses["moe"] = float(estep.step(ex, et, torch.zeros(1, device=dev)))
        assert np.isfinite(losses["moe"])
        _print(rank, f"dryrun_multichip({n}): moe mesh dp={n // ep} ep={ep} "
                     f"(4 experts, top-2), one step done, "
                     f"loss={losses['moe']:.4f}")
    return losses


def main(argv=None):
    import argparse
    import torch.distributed as dist

    import tpu_mx_torch as mx
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the host instead of the card")
    args = ap.parse_args(argv)
    if not (dist.is_available() and dist.is_initialized()):
        raise SystemExit("dryrun_multichip: start the ranks through "
                         "python -m tpu_mx_torch.tools.launch -n N")
    torch.set_num_threads(1)
    with (mx.cpu() if args.cpu else mx.gpu(torch.cuda.current_device())):
        dryrun_multichip(dist.get_world_size(),
                         device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
