"""The port's meshes, collectives, ring and Ulysses attention and GPipe
pipeline on 2 and 4 ``gloo`` ranks on the CPU, held to the reference.

The ranks are one pool of 4 spawned processes for the whole file (a
module-scoped fixture; each rank runs ``torch.set_num_threads(1)``):
every case function runs on all 4 ranks, and a 2-rank case builds its
mesh on ranks 0 and 1 (ranks 2 and 3 take part in the group creation
and return None).  The rank functions import no jax: the parent runs
the reference — on its virtual CPU devices, a mesh of the same shape,
at the reference tests' own small shapes — and compares.

Tolerances: f32 results of the same math in two packages, 1e-5
(``ATOL``); gradients 2e-5 absolute plus 2e-4 relative, the reference's
own ring/pipeline gradient tolerance.
"""
import os
import socket
import traceback

import numpy as np
import pytest
import torch

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
WORLD = 4
CALL_TIMEOUT = 240


# -- the rank pool -------------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank, world, port, conn):
    import datetime

    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.pop("TPUMX_COORDINATOR", None)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=CALL_TIMEOUT))
    import tpu_mx_torch as mx
    while True:
        job = conn.recv()
        if job is None:
            break
        fn, args = job
        try:
            with mx.cpu():
                conn.send(("ok", fn(*args)))
        except BaseException:  # noqa: BLE001 — sent to the parent
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` processes joined in one ``gloo`` group; :meth:`run`
    calls a module-level function on every rank and returns the list of
    their results (a rank's exception is raised here with its
    traceback)."""

    def __init__(self, world):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(rank, world, port, child),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, fn, *args):
        for c in self.conns:
            c.send((fn, args))
        answers = []
        for rank, c in enumerate(self.conns):
            if not c.poll(CALL_TIMEOUT):
                self.close()
                raise TimeoutError(f"rank {rank} gave no answer to "
                                   f"{fn.__name__} in {CALL_TIMEOUT} s")
            answers.append(c.recv())
        for rank, (status, value) in enumerate(answers):
            if status == "err":
                raise RuntimeError(f"rank {rank}:\n{value}")
        return [value for _, value in answers]

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _np(t):
    return t.detach().float().numpy().copy()


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale) \
        .astype(np.float32)


def _jmesh(axes):
    import jax
    from tpu_mx.parallel import make_mesh as jmake
    n = int(np.prod(list(axes.values())))
    return jmake(axes, devices=jax.devices()[:n])


# -- the mesh ------------------------------------------------------------------
def _rank_mesh_shapes():
    from tpu_mx_torch.parallel import hybrid_mesh, make_mesh
    m = make_mesh({"dp": 2, "tp": -1})
    out = {"shape": m.shape, "coords": m.coords, "size": m.size,
           "ranks": m.ranks.tolist()}
    errors = []
    for bad in ({"dp": 3}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}):
        try:
            make_mesh(bad)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    sub = make_mesh({"sp": 2}, devices=[2, 3])
    out["sub_coords"] = sub.coords
    h = hybrid_mesh({"dp": 1, "tp": 2}, {"dp": 2})
    out["hybrid"] = h.shape
    out["index"] = [h.axis_index(("dp", "tp")), h.axis_index(("tp", "dp"))]
    return out


def test_make_mesh_over_the_ranks(pool):
    res = pool.run(_rank_mesh_shapes)
    for rank, r in enumerate(res):
        assert r["shape"] == {"dp": 2, "tp": 2} and r["size"] == 4
        assert r["ranks"] == [[0, 1], [2, 3]]
        assert r["coords"] == {"dp": rank // 2, "tp": rank % 2}
        assert len(r["errors"]) == 3
        assert "needs 3 devices, have 4" in r["errors"][0]
        assert "at most one axis" in r["errors"][1]
        assert "not divisible by 3" in r["errors"][2]
        assert r["sub_coords"] == ({"sp": rank - 2} if rank >= 2 else None)
        assert r["hybrid"] == {"dp": 2, "tp": 2}
        assert r["index"] == [rank, 2 * (rank % 2) + rank // 2]


def test_make_mesh_without_a_group_names_it():
    from tpu_mx_torch.base import MXNetError
    from tpu_mx_torch.parallel import make_mesh
    with pytest.raises(MXNetError, match="no process group"):
        make_mesh({"dp": 2})
    assert make_mesh({"dp": 1}, devices=["cpu"]).size == 1


# -- the collectives -----------------------------------------------------------
def _rank_collectives():
    from tpu_mx_torch.parallel import collectives as C
    from tpu_mx_torch.parallel import make_mesh
    m = make_mesh({"dp": 2, "sp": 2})
    r = m.rank
    out = {}
    x = torch.full((2, 4), float(r + 1), requires_grad=True)
    y = C.psum(x, m, "sp")
    (y * (r + 1)).sum().backward()
    out["psum"] = (_np(y), _np(x.grad))
    x = torch.arange(4.0).reshape(1, 4) + 10 * r
    x.requires_grad_()
    g = C.all_gather(x, m, ("dp", "sp"), dim=0)
    (g * torch.arange(16.0).reshape(4, 4)).sum().backward()
    out["gather"] = (_np(g), _np(x.grad))
    x = torch.arange(8.0).reshape(2, 4) + 100 * r
    out["a2a"] = _np(C.all_to_all(x, m, "sp", 1, 0))
    x = torch.full((3,), float(r), requires_grad=True)
    p = C.ppermute(x, m, "dp", [(0, 1)])
    (p * 2).sum().backward()
    out["ppermute"] = (_np(p), _np(x.grad))
    w = torch.ones(3, requires_grad=True)
    (C.copy_to(w, m, "dp") * (r + 1)).sum().backward()
    out["copy_to"] = _np(w.grad)
    out["index"] = C.axis_index(m, ("sp", "dp"))
    return out


def test_collectives_and_their_gradients(pool):
    res = pool.run(_rank_collectives)
    for r, o in enumerate(res):
        dp, sp = divmod(r, 2)
        peer = dp * 2 + (1 - sp)
        y, gx = o["psum"]
        assert np.all(y == (r + 1) + (peer + 1))
        assert np.all(gx == r + 1)           # the cotangent passes through
        g, gx = o["gather"]
        np.testing.assert_array_equal(
            g, np.arange(4.0)[None] + 10 * np.arange(4.0)[:, None])
        np.testing.assert_array_equal(gx,
                                      np.arange(16.0).reshape(4, 4)[r:r + 1])
        # tiled: column block j goes to the sp rank j, blocks received
        # are stacked in sp order
        mine = np.arange(8.0).reshape(2, 4) + 100 * r
        theirs = np.arange(8.0).reshape(2, 4) + 100 * peer
        blocks = {sp: mine[:, 2 * sp:2 * sp + 2],
                  1 - sp: theirs[:, 2 * sp:2 * sp + 2]}
        np.testing.assert_array_equal(o["a2a"],
                                      np.concatenate([blocks[0], blocks[1]]))
        p, gx = o["ppermute"]
        assert np.all(p == (r - 2 if dp == 1 else 0))
        assert np.all(gx == (2.0 if dp == 0 else 0.0))
        # the cotangents (r + 1) summed over the two dp ranks of this sp
        assert np.all(o["copy_to"] == (sp + 1) + (sp + 3))
        assert o["index"] == sp * 2 + dp


# -- ring attention ------------------------------------------------------------
def _loss_grads(fn, q, k, v):
    """``sum(sin(fn(q, k, v)))`` and its q/k/v gradients, numpy."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(q, k, v)
    torch.sin(out).sum().backward()
    return _np(out), [_np(x.grad) for x in (q, k, v)]


def _jax_loss_grads(fn, q, k, v):
    import jax
    import jax.numpy as jnp
    out = fn(*(jnp.asarray(x) for x in (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_same(got, want):
    out, grads = got
    wout, wgrads = want
    np.testing.assert_allclose(out, wout, rtol=0, atol=ATOL)
    for g, w, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


RING_CASES = {
    # name: (mesh axes, B, H, T, D, kwargs)
    "sp4": ({"sp": 4}, 2, 2, 32, 4, {}),
    "sp4_causal": ({"sp": 4}, 2, 2, 32, 4, {"causal": True}),
    "sp2_padded_causal": ({"sp": 2}, 2, 2, 32, 4,
                          {"causal": True, "valid": [32, 16]}),
    "dp2_sp2_bias": ({"dp": 2, "sp": 2}, 2, 2, 32, 8, {"bias": True}),
    "sp4_chunked": ({"sp": 4}, 2, 2, 64, 8,
                    {"causal": True, "bias": True, "valid": [64, 32],
                     "step_chunk": 8}),
    "sp2_tp2": ({"sp": 2, "tp": 2}, 2, 4, 16, 4, {"causal": True}),
}
# Ulysses needs the heads to divide by sp
ULYSSES_CASES = {
    "sp4": ({"sp": 4}, 2, 4, 32, 4, {}),
    "sp4_causal": ({"sp": 4}, 2, 4, 32, 4, {"causal": True}),
    "sp2_padded_causal": RING_CASES["sp2_padded_causal"],
    "dp2_sp2_bias": RING_CASES["dp2_sp2_bias"],
}


def _ring_inputs(b, h, t, d, kw):
    q, k, v = (_rand(s, b, h, t, d) for s in (1, 2, 3))
    bias = (np.random.RandomState(4).randn(1, h, t, t) * 0.1)\
        .astype(np.float32) if kw.get("bias") else None
    return q, k, v, bias


def _rank_ring(case, strategy):
    from tpu_mx_torch.parallel import make_mesh, ring_attention
    from tpu_mx_torch.parallel import ulysses_attention
    axes, b, h, t, d, kw = (RING_CASES if strategy == "ring"
                            else ULYSSES_CASES)[case]
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=list(range(n)))
    if mesh.coords is None:
        return None
    q, k, v, bias = _ring_inputs(b, h, t, d, kw)
    fn = ring_attention if strategy == "ring" else ulysses_attention
    extra = {"step_chunk": kw["step_chunk"]} if "step_chunk" in kw else {}
    return _loss_grads(
        lambda q, k, v: fn(q, k, v, mesh, causal=kw.get("causal", False),
                           valid_length=kw.get("valid"),
                           bias=None if bias is None else torch.tensor(bias),
                           **extra), q, k, v)


def _ref_ring(case, strategy):
    """The reference on its own mesh for the cases of ``MESH_REF``; for
    the others its one-device attention, which its own tests hold its
    ring and Ulysses paths to (a mesh program's gradient compiles for
    ~15 s on the CPU)."""
    from tpu_mx.parallel import local_flash_attention as jlocal
    from tpu_mx.parallel import ring_attention as jring
    from tpu_mx.parallel import ulysses_attention as july
    axes, b, h, t, d, kw = (RING_CASES if strategy == "ring"
                            else ULYSSES_CASES)[case]
    q, k, v, bias = _ring_inputs(b, h, t, d, kw)
    valid = None if "valid" not in kw else np.asarray(kw["valid"])
    common = dict(causal=kw.get("causal", False), valid_length=valid,
                  bias=bias)
    if (strategy, case) not in MESH_REF:
        return _jax_loss_grads(lambda q, k, v: jlocal(q, k, v, **common),
                               q, k, v)
    mesh = _jmesh(axes)
    fn = jring if strategy == "ring" else july
    extra = {"step_chunk": kw["step_chunk"]} if "step_chunk" in kw else {}
    return _jax_loss_grads(lambda q, k, v: fn(q, k, v, mesh, **common,
                                              **extra), q, k, v)


MESH_REF = {("ring", "sp4_causal"), ("ulysses", "sp4_causal")}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_the_references_mesh(pool, case):
    res = pool.run(_rank_ring, case, "ring")
    want = _ref_ring(case, "ring")
    n = int(np.prod(list(RING_CASES[case][0].values())))
    for got in res[:n]:
        _assert_same(got, want)
    assert all(r is None for r in res[n:])


@pytest.mark.parametrize("case", sorted(ULYSSES_CASES))
def test_ulysses_attention_matches_the_references_mesh(pool, case):
    axes = ULYSSES_CASES[case][0]
    res = pool.run(_rank_ring, case, "ulysses")
    want = _ref_ring(case, "ulysses")
    n = int(np.prod(list(axes.values())))
    for got in res[:n]:
        _assert_same(got, want)


def _rank_ulysses_heads():
    from tpu_mx_torch.parallel import make_mesh, ulysses_attention
    mesh = make_mesh({"sp": 4})
    q = torch.zeros(1, 6, 16, 4)
    try:
        ulysses_attention(q, q, q, mesh)
    except ValueError as e:
        return str(e)


def test_ulysses_refuses_heads_that_do_not_divide(pool):
    for msg in pool.run(_rank_ulysses_heads):
        assert "heads (6) must divide by sp (4)" in msg


def _rank_dispatch():
    from tpu_mx_torch.parallel import (attention, dispatch_counts,
                                       make_mesh, set_sp_strategy)
    mesh = make_mesh({"dp": 2, "sp": 2})
    rng = np.random.RandomState(1)
    mk = lambda h: [torch.tensor(rng.rand(2, h, 24, 4).astype(np.float32))
                    for _ in range(3)]
    out = {}
    prev = set_sp_strategy("ulysses")
    try:
        before = dict(dispatch_counts)
        q, k, v = mk(4)
        a1 = attention(q, k, v, mesh=mesh)
        out["ulysses"] = dispatch_counts["ulysses"] - before["ulysses"]
        q6 = mk(3)
        attention(*q6, mesh=mesh)                    # 3 % 2: ring
        out["ring"] = dispatch_counts["ring"] - before["ring"]
        a3 = attention(q, k, v, mesh=mesh, sp_strategy="ring")
        out["diff"] = float((a1 - a3).abs().max())
        local = attention(q, k, v)
        out["local_diff"] = float((a1 - local).abs().max())
        tp = make_mesh({"sp": 2, "tp": 2})
        r0 = dispatch_counts["ring"]
        attention(*mk(6), mesh=tp)                   # tp > 1: ring
        out["tp_ring"] = dispatch_counts["ring"] - r0
    finally:
        set_sp_strategy(prev)
    return out


def test_attention_dispatches_ring_and_ulysses(pool):
    for o in pool.run(_rank_dispatch):
        assert o["ulysses"] == 1 and o["ring"] == 1 and o["tp_ring"] == 1
        assert o["diff"] < ATOL and o["local_diff"] < ATOL


def _rank_dropout(kind):
    """Ring/Ulysses attention-probability dropout at rate 0.25 on a
    dp=2 x sp=2 mesh: the output's batch rows 0 and 1 carry the same
    q/k/v, so equal rows would mean the dp shards drew one mask."""
    from tpu_mx_torch.parallel import (make_mesh, ring_attention,
                                       ulysses_attention)
    mesh = make_mesh({"dp": 2, "sp": 2})
    b, h, t, d = 2, 2, 64, 8
    one = torch.tensor(_rand(5, 1, h, t, d))
    q = k = one.expand(b, h, t, d).contiguous()
    v = torch.ones(b, h, t, d)
    fn = ring_attention if kind == "ring" else ulysses_attention
    seed = torch.tensor([1234], dtype=torch.int32)
    out = fn(q, k, v, mesh, dropout_rate=0.25, dropout_seed=seed)
    again = fn(q, k, v, mesh, dropout_rate=0.25, dropout_seed=seed)
    # with v = 1 each output is (kept probability mass) / (1 - rate):
    # its mean over rows is the keep rate's estimate divided by 0.75
    return {"mean": float(out.mean()), "rows_equal":
            bool(torch.equal(out[0], out[1])),
            "repeat": bool(torch.equal(out, again))}


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sp_dropout_keeps_its_rate_and_differs_by_shard(pool, kind):
    for o in pool.run(_rank_dropout, kind):
        assert abs(o["mean"] - 1.0) < 0.03     # 2*2*64*64 draws
        assert not o["rows_equal"] and o["repeat"]


# -- the pipeline --------------------------------------------------------------
def _mlp_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _stage_arrays(s_count, d=8, hidden=16):
    rng = np.random.RandomState(0)
    stages = []
    for _ in range(s_count):
        stages.append({"w1": (rng.randn(d, hidden) * 0.3).astype(np.float32),
                       "b1": np.zeros(hidden, np.float32),
                       "w2": (rng.randn(hidden, d) * 0.3).astype(np.float32),
                       "b2": np.zeros(d, np.float32)})
    x = rng.randn(32, d).astype(np.float32)
    return stages, x


PIPE_CASES = {"dp2_pp2_m4": ({"dp": 2, "pp": 2}, 4),
              "dp1_pp4_m4": ({"dp": 1, "pp": 4}, 4),
              "dp2_pp2_m8": ({"dp": 2, "pp": 2}, 8)}


def _rank_pipeline(case):
    from tpu_mx_torch.parallel import (P, make_mesh, pipeline_apply,
                                       stack_stage_params)
    axes, micro = PIPE_CASES[case]
    mesh = make_mesh(axes)
    stages, x = _stage_arrays(axes["pp"])
    stacked = stack_stage_params([{k: torch.tensor(a) for k, a in s.items()}
                                  for s in stages])
    for a in stacked.values():
        a.requires_grad_()
    y = pipeline_apply(_mlp_stage, stacked, torch.tensor(x), mesh,
                       num_microbatches=micro, data_spec=P("dp"))
    loss = torch.sin(y).sum()
    loss.backward()
    return float(loss), {k: _np(a.grad) for k, a in stacked.items()}


def test_pipeline_matches_the_references_schedule(pool):
    """dp=2 x pp=2, 4 microbatches: loss and stacked-parameter gradients
    against the reference's GPipe program on its own mesh."""
    import jax
    import jax.numpy as jnp
    from tpu_mx.parallel import P as JP
    from tpu_mx.parallel import pipeline_apply as jpipe
    from tpu_mx.parallel import stack_stage_params as jstack

    def jstage(p, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    case = "dp2_pp2_m4"
    axes, micro = PIPE_CASES[case]
    stages, x = _stage_arrays(axes["pp"])
    jstacked = jstack([{k: jnp.asarray(a) for k, a in s.items()}
                       for s in stages])
    mesh = _jmesh(axes)
    jloss = lambda st: jnp.sum(jnp.sin(jpipe(
        jstage, st, jnp.asarray(x), mesh, num_microbatches=micro,
        data_spec=JP("dp"))))
    want_l, want_g = jax.value_and_grad(jloss)(jstacked)
    for loss, grads in pool.run(_rank_pipeline, case):
        assert abs(loss - float(want_l)) < 1e-4
        for k in grads:
            np.testing.assert_allclose(grads[k], np.asarray(want_g[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["dp1_pp4_m4", "dp2_pp2_m8"])
def test_pipeline_matches_sequential_stages(pool, case):
    """The stages applied one after the other on the whole batch, in
    one process: the function the schedule computes."""
    axes, _ = PIPE_CASES[case]
    stages, x = _stage_arrays(axes["pp"])
    params = [{k: torch.tensor(a, requires_grad=True) for k, a in s.items()}
              for s in stages]
    y = torch.tensor(x)
    for p in params:
        y = _mlp_stage(p, y)
    want = torch.sin(y).sum()
    want.backward()
    for loss, grads in pool.run(_rank_pipeline, case):
        assert abs(loss - float(want.detach())) < 1e-4
        for k in grads:
            np.testing.assert_allclose(
                grads[k], np.stack([_np(p[k].grad) for p in params]),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def _rank_pipeline_trains():
    from tpu_mx_torch.parallel import (P, make_mesh, pipeline_apply,
                                       stack_stage_params)
    mesh = make_mesh({"dp": 2, "pp": 2})
    stages, _ = _stage_arrays(2, d=4, hidden=8)
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(16, 4).astype(np.float32))
    t = x @ torch.tensor((rng.randn(4, 4) * 0.3).astype(np.float32))
    stacked = stack_stage_params([{k: torch.tensor(a) for k, a in s.items()}
                                  for s in stages])
    losses = []
    for _ in range(60):
        for a in stacked.values():
            a.requires_grad_()
        y = pipeline_apply(_mlp_stage, stacked, x, mesh, num_microbatches=4,
                           data_spec=P("dp"))
        loss = ((y - t) ** 2).mean()
        grads = torch.autograd.grad(loss, list(stacked.values()))
        stacked = {k: (a - 0.5 * g).detach()
                   for (k, a), g in zip(stacked.items(), grads)}
        losses.append(float(loss))
    return losses


def test_pipeline_trains(pool):
    for losses in pool.run(_rank_pipeline_trains):
        assert losses[-1] < 0.5 * losses[0], losses


# -- DTensor, the backend, host staging ----------------------------------------
def _rank_dtensor():
    """A spec as DTensor placements; ring attention on DTensors takes
    their local blocks and returns a DTensor laid out alike."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from tpu_mx_torch.parallel import (NamedSharding, P, make_mesh,
                                       ring_attention)
    from tpu_mx_torch.parallel.mesh import distribute
    mesh = make_mesh({"dp": 2, "sp": 2})
    sh = NamedSharding(mesh, P("dp", None, "sp", None))
    q, k, v = (torch.tensor(_rand(s, 2, 2, 16, 4)) for s in (1, 2, 3))
    dq, dk, dv = (distribute(x, sh) for x in (q, k, v))
    out = ring_attention(dq, dk, dv, mesh, causal=True)
    return {"placements": [str(p) for p in sh.placements()],
            "want": [str(Shard(0)), str(Shard(2))],
            "local": tuple(dq.to_local().shape),
            "is_dtensor": isinstance(out, DTensor),
            "out": _np(out.full_tensor()),
            "replicate": str(NamedSharding(mesh, P()).placements()[0])
            == str(Replicate())}


def test_specs_map_to_dtensor_placements(pool):
    from tpu_mx_torch.parallel import local_flash_attention
    q, k, v = (torch.tensor(_rand(s, 2, 2, 16, 4)) for s in (1, 2, 3))
    want = _np(local_flash_attention(q, k, v, causal=True))
    for o in pool.run(_rank_dtensor):
        assert o["placements"] == o["want"] and o["replicate"]
        assert o["local"] == (1, 2, 8, 4) and o["is_dtensor"]
        np.testing.assert_allclose(o["out"], want, rtol=0, atol=ATOL)


def test_backend_is_a_function_of_the_device_and_the_cards():
    from tpu_mx_torch.base import backend_for
    assert backend_for("cuda", 1) == "nccl"
    assert backend_for("cuda", 2) == "gloo"        # ranks share a card
    assert backend_for("cpu", 1) == "gloo"


def test_mesh_backend_follows_where_its_ranks_compute():
    """A host with four cards, simulated through the placements the
    mesh gathers: NCCL only where no two ranks share a card."""
    from tpu_mx_torch.parallel.mesh import group_backend
    cards = [("h", f"cuda:{i}") for i in range(4)]
    assert group_backend(cards) == "nccl"
    assert group_backend([("h", "cuda:0")] * 4) == "gloo"
    assert group_backend(cards[:2] + [("h", "cuda:1")]) == "gloo"
    assert group_backend([("a", "cuda:0"), ("b", "cuda:0")]) == "nccl"
    assert group_backend([("h", "cpu")] * 4) == "gloo"
    assert group_backend(cards[:3] + [("h", "cpu")]) == "gloo"


def test_dist_boot_joins_gloo_on_a_host_with_many_cards(monkeypatch):
    """The launcher's group is host memory whatever the host holds: the
    kvstore's gathers and host ranks hand it host tensors."""
    import atexit
    import torch.distributed as dist
    from tpu_mx_torch import base
    joined = {}
    monkeypatch.setenv("TPUMX_COORDINATOR", "localhost:1")
    monkeypatch.setenv("TPUMX_NUM_PROC", "4")
    monkeypatch.setenv("TPUMX_PROC_ID", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(kw, b=backend))
    monkeypatch.setattr(atexit, "register", lambda fn: None)
    assert base.dist_boot()
    assert joined["b"] == "gloo" and joined["rank"] == 2
    assert joined["world_size"] == 4


def _rank_mesh_backend():
    from tpu_mx_torch.parallel import make_mesh
    return make_mesh({"dp": 2, "tp": 2}).backend


def test_host_ranks_mesh_over_gloo(pool):
    assert pool.run(_rank_mesh_backend) == ["gloo"] * 4


def _rank_host_staging():
    from tpu_mx_torch.parallel import collectives as C
    from tpu_mx_torch.parallel import make_mesh
    mesh = make_mesh({"dp": 4})
    before = C.host_staged_stats()
    C.psum(torch.ones(8), mesh, "dp")
    return before == C.host_staged_stats()


def test_host_tensors_are_not_staged(pool):
    """Staging is for CUDA tensors over gloo only: host collectives move
    nothing through it."""
    assert all(pool.run(_rank_host_staging))
