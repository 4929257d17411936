"""How the runtime-D flash forward and dk/dv split a head dim of 320 and
more over their warpgroups (``flash_attention.runtime_d_split``, the rule
``split_d``/``slice_of`` of ``csrc/flash_dn.cuh``): a pure host-side
function, checked here for every multiple of 64 from 320 to 4608.  On the
card, ``tests/test_torch_cuda.py::test_runtime_d_split_is_the_kernels_own``
holds the split the built libraries launch with to it."""
import re
from pathlib import Path

import pytest
import torch

from tpu_mx_torch.kernels import flash_attention as fa

DIMS = range(320, 4609, 64)
KERNELS = ("fwd", "dkv")
DTYPES = (torch.bfloat16, torch.float32)
# the most columns a warpgroup holds: 256 of O, 128 each of dK and dV
MOST_COLUMNS = {"fwd": 256, "dkv": 128}
GRID_X, GRID_Y = 2 ** 31 - 1, 65535


def _covers_once(slices, d):
    cols = sorted((c0, n) for c0, n in slices if n)
    at = 0
    for c0, n in cols:
        if c0 != at:
            return False
        at += n
    return at == d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", DIMS)
def test_slices_cover_the_head_dim_once(d, kernel, dtype):
    sp = fa.runtime_d_split(d, kernel, dtype, rows=4096, bh=65535)
    assert 1 <= sp["cluster"] <= fa.DN_CLUSTER_MAX
    assert sp["warpgroups"] == 2 * sp["cluster"]
    assert len(sp["slices"]) == sp["passes"]
    # every pass's output columns, then all of them, cover D once
    out = [s for p in sp["slices"] for s in p]
    assert _covers_once(out, d)
    assert all(len(p) == sp["warpgroups"] for p in sp["slices"])
    assert all(c0 % 64 == 0 and n % 64 == 0 and n <= MOST_COLUMNS[kernel]
               for c0, n in out)
    # the score products of each pass sum over all of D
    assert len(sp["score_slices"]) == sp["warpgroups"]
    assert _covers_once(sp["score_slices"], d)
    assert all(c0 % 64 == 0 and n % 64 == 0 for c0, n in sp["score_slices"])
    gx, gy, gz = sp["grid"]
    assert gx == sp["cluster"] * sp["passes"] * 64 and gx <= GRID_X
    assert gy == 65535 <= GRID_Y and gz == 1
    # more passes only where one cluster cannot hold the columns
    most = fa.DN_CLUSTER_MAX * 2 * fa.DN_WG_BLOCKS[kernel, dtype]
    assert (sp["passes"] > 1) == (d // 64 > most)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", [320, 384, 448, 512, 576, 1024])
def test_one_pass_computes_each_score_product_once(d, kernel, dtype):
    """At the head dims the repo measures, one cluster holds all of D:
    the recompute factor is 1."""
    sp = fa.runtime_d_split(d, kernel, dtype)
    assert sp["passes"] == 1
    assert sp["slices"][0] == sp["score_slices"]


@pytest.mark.parametrize("d, kernel, cluster, slices", [
    (320, "fwd", 1, ((0, 192), (192, 128))),
    (512, "fwd", 1, ((0, 256), (256, 256))),
    (576, "fwd", 2, ((0, 192), (192, 128), (320, 128), (448, 128))),
    (320, "dkv", 2, ((0, 128), (128, 64), (192, 64), (256, 64))),
    (2048, "dkv", 8, tuple((128 * i, 128) for i in range(16))),
])
def test_bf16_splits(d, kernel, cluster, slices):
    sp = fa.runtime_d_split(d, kernel, torch.bfloat16)
    assert (sp["cluster"], sp["passes"], sp["slices"][0]) == \
        (cluster, 1, slices)


def test_the_rule_has_the_sources_constants():
    """The C rule's constants (csrc/flash_dn.cuh) are the Python rule's."""
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_dn.cuh").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+);", src).group(1))

    assert const("kClusterMax") == fa.DN_CLUSTER_MAX
    assert const("kFwdCapBlocks") == fa.DN_WG_BLOCKS["fwd", torch.bfloat16] \
        == fa.DN_WG_BLOCKS["fwd", torch.float32]
    dkv = re.search(r"kDkvCapBlocks = sizeof\(T\) == 4 \? (\d+) : (\d+);",
                    src)
    assert (int(dkv.group(1)), int(dkv.group(2))) == (
        fa.DN_WG_BLOCKS["dkv", torch.float32],
        fa.DN_WG_BLOCKS["dkv", torch.bfloat16])
    mins = re.search(r"kFwdMinBlocks = (\d+), kDkvMinBlocks = (\d+);", src)
    assert (int(mins.group(1)), int(mins.group(2))) == (
        fa.DN_MIN_BLOCKS["fwd"], fa.DN_MIN_BLOCKS["dkv"])
