"""The port's sparse storage (``nd.sparse``), ``io.LibSVMIter`` and
``KVStore.row_sparse_pull`` against the reference's, on the CPU: each
test of ``tests/test_sparse.py`` with the reference beside it on the same
seeded inputs.

Tolerances: storage conversions, slices, retains and the iterator's
batches are exact (the same values moved); ``dot`` sums float32 products
in another order than the reference's segment sum, within 1e-6 relative
(a few units in the last place of sums of at most a few dozen terms).
"""
import warnings

import numpy as np
import pytest

import tpu_mx as jmx
from tpu_mx import nd as jnd
from tpu_mx.ndarray import sparse as jsparse

import tpu_mx_torch as mx
from tpu_mx_torch import nd
from tpu_mx_torch.ndarray import sparse

DOT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _dense(m=6, n=5, density=0.4, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.rand(m, n).astype(np.float32)
    dense[rng.rand(m, n) > density] = 0.0
    return dense


def _same_csr(got, want):
    assert got.stype == want.stype == "csr"
    assert got.shape == want.shape and got.nnz == want.nnz
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, part).asnumpy(),
                                      getattr(want, part).asnumpy())


def test_csr_roundtrip():
    dense = _dense()
    csr, jcsr = sparse.csr_matrix(dense), jsparse.csr_matrix(dense)
    _same_csr(csr, jcsr)
    np.testing.assert_array_equal(csr.asnumpy(), dense)
    csr2 = sparse.csr_matrix((csr.data, csr.indices, csr.indptr),
                             shape=dense.shape)
    _same_csr(csr2, jcsr)
    # the reference's arrays go in as they are
    _same_csr(sparse.csr_matrix((jcsr.data.asnumpy(), jcsr.indices.asnumpy(),
                                 jcsr.indptr.asnumpy()), shape=dense.shape),
              jcsr)
    assert csr.dtype == jcsr.dtype == "float32"
    assert str(csr.context) == "cpu(0)"


def test_csr_nnz_and_slice():
    dense = _dense()
    csr, jcsr = sparse.csr_matrix(dense), jsparse.csr_matrix(dense)
    assert csr.nnz == jcsr.nnz == int((dense != 0).sum())
    _same_csr(csr.slice(1, 4), jcsr.slice(1, 4))
    np.testing.assert_array_equal(csr.slice(1, 4).asnumpy(), dense[1:4])
    with pytest.raises(IndexError, match="out of bounds"):
        csr.slice(2, 9)
    with pytest.raises(IndexError, match="out of bounds"):
        jcsr.slice(2, 9)


def test_row_sparse_roundtrip():
    dense = np.zeros((8, 3), np.float32)
    dense[[1, 4, 6]] = np.random.RandomState(0).rand(3, 3)
    rsp, jrsp = sparse.row_sparse_array(dense), jsparse.row_sparse_array(dense)
    assert rsp.stype == jrsp.stype == "row_sparse"
    np.testing.assert_array_equal(rsp.indices.asnumpy(),
                                  jrsp.indices.asnumpy())
    np.testing.assert_array_equal(rsp.data.asnumpy(), jrsp.data.asnumpy())
    np.testing.assert_array_equal(rsp.asnumpy(), dense)
    rsp2 = sparse.row_sparse_array((rsp.data, rsp.indices), shape=(8, 3))
    np.testing.assert_array_equal(rsp2.asnumpy(), dense)
    # duplicate rows add up when densified, in both
    dup = (np.ones((2, 3), np.float32), np.array([2, 2]))
    np.testing.assert_array_equal(
        sparse.row_sparse_array(dup, shape=(4, 3)).asnumpy(),
        jsparse.row_sparse_array(dup, shape=(4, 3)).asnumpy())
    for bad in ((np.ones((2, 3), np.float32), np.array([1])),
                (np.ones((2, 2), np.float32), np.array([1, 2]))):
        with pytest.raises(ValueError, match="row_sparse"):
            sparse.row_sparse_array(bad, shape=(4, 3))
        with pytest.raises(ValueError, match="row_sparse"):
            jsparse.row_sparse_array(bad, shape=(4, 3))


@pytest.mark.parametrize("transpose_a,transpose_b", [
    (False, False), (True, False), (False, True)])
def test_dot_csr_dense(transpose_a, transpose_b):
    dense = _dense(seed=3)
    rng = np.random.RandomState(1)
    rows = dense.shape[0] if transpose_a else dense.shape[1]
    rhs = rng.rand(rows, 4).astype(np.float32)
    if transpose_b:
        rhs = np.ascontiguousarray(rhs.T)
    got = sparse.dot(sparse.csr_matrix(dense), nd.array(rhs),
                     transpose_a=transpose_a, transpose_b=transpose_b)
    want = jsparse.dot(jsparse.csr_matrix(dense), jnd.array(rhs),
                       transpose_a=transpose_a, transpose_b=transpose_b)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                               rtol=DOT_RTOL, atol=1e-7)
    a = dense.T if transpose_a else dense
    b = rhs.T if transpose_b else rhs
    np.testing.assert_allclose(got.asnumpy(), a.astype(np.float64) @ b,
                               rtol=DOT_RTOL, atol=1e-7)


def test_dot_dense_csr_and_dense_dense():
    dense = _dense(seed=4)
    lhs = np.random.RandomState(2).rand(3, 6).astype(np.float32)
    got = sparse.dot(nd.array(lhs), sparse.csr_matrix(dense))
    want = jsparse.dot(jnd.array(lhs), jsparse.csr_matrix(dense))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                               rtol=DOT_RTOL, atol=1e-7)
    got = sparse.dot(nd.array(lhs), nd.array(dense))
    want = jsparse.dot(jnd.array(lhs), jnd.array(dense))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                               rtol=DOT_RTOL, atol=1e-7)
    with pytest.raises(TypeError, match="unsupported operands"):
        sparse.dot(sparse.csr_matrix(dense), sparse.csr_matrix(dense))
    with pytest.raises(TypeError, match="unsupported operands"):
        jsparse.dot(jsparse.csr_matrix(dense), jsparse.csr_matrix(dense))


def test_tostype_and_cast_storage():
    dense = _dense()
    a, ja = nd.array(dense), jnd.array(dense)
    assert a.stype == ja.stype == "default"
    csr = a.tostype("csr")
    _same_csr(csr, ja.tostype("csr"))
    back = csr.tostype("default")
    assert type(back).__name__ == "NDArray"
    np.testing.assert_array_equal(back.asnumpy(), dense)
    rsp = sparse.cast_storage(a, "row_sparse")
    np.testing.assert_array_equal(rsp.asnumpy(), dense)
    np.testing.assert_array_equal(
        rsp.indices.asnumpy(),
        jsparse.cast_storage(ja, "row_sparse").indices.asnumpy())
    assert sparse.tostype(csr, "csr") is csr
    assert sparse.cast_storage(a, "default") is a
    for bad in (lambda m: m.cast_storage(m.csr_matrix(dense), "row_sparse"),
                lambda m: m.cast_storage(m.row_sparse_array(dense), "csr")):
        with pytest.raises(ValueError, match="cannot convert"):
            bad(sparse)
        with pytest.raises(ValueError, match="cannot convert"):
            bad(jsparse)
    f16 = csr.astype("float16")
    assert f16.dtype == ja.tostype("csr").astype("float16").dtype == "float16"


def test_retain():
    dense = np.zeros((10, 2), np.float32)
    dense[[2, 5, 7]] = np.arange(6, dtype=np.float32).reshape(3, 2) + 1
    rsp, jrsp = sparse.row_sparse_array(dense), jsparse.row_sparse_array(dense)
    want = jsparse.retain(jrsp, jnd.array(np.array([7, 5], np.int32)))
    for ids in (nd.array(np.array([7, 5], np.int32)), [7, 5],
                np.array([7, 5])):
        kept = sparse.retain(rsp, ids)
        np.testing.assert_array_equal(kept.indices.asnumpy(),
                                      want.indices.asnumpy())
        np.testing.assert_array_equal(kept.asnumpy(), want.asnumpy())
    with pytest.raises(TypeError, match="RowSparseNDArray"):
        sparse.retain(nd.array(dense), [1])


def test_rowsparse_add_accumulates_duplicates():
    def pair(m):
        a = m.row_sparse_array((np.ones((2, 3), np.float32),
                                np.array([4, 2])), shape=(5, 3))
        b = m.row_sparse_array((np.full((3, 3), 2, np.float32),
                                np.array([2, 0, 2])), shape=(5, 3))
        return m.elemwise_add(a, b)
    got, want = pair(sparse), pair(jsparse)
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(got.data.asnumpy(), want.data.asnumpy())
    # a dense operand adds densely
    dense = np.ones((5, 3), np.float32)
    got = sparse.elemwise_add(sparse.row_sparse_array(dense), nd.array(dense))
    want = jsparse.elemwise_add(jsparse.row_sparse_array(dense),
                                jnd.array(dense))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        sparse.elemwise_add(sparse.zeros("row_sparse", (2, 3)),
                            sparse.zeros("row_sparse", (3, 3)))


def test_sparse_zeros():
    for stype in ("csr", "row_sparse", "default"):
        z, jz = sparse.zeros(stype, (4, 6)), jsparse.zeros(stype, (4, 6))
        assert z.stype == jz.stype == stype
        np.testing.assert_array_equal(z.asnumpy(), jz.asnumpy())
    assert sparse.zeros("csr", (4, 6)).nnz == 0
    with pytest.raises(ValueError, match="unknown storage type"):
        sparse.zeros("coo", (2, 2))
    with pytest.raises(ValueError, match="unknown storage type"):
        jsparse.zeros("coo", (2, 2))


def test_dense_ops_reject_sparse():
    csr = sparse.csr_matrix(_dense())
    with pytest.raises(Exception):
        nd.dot(csr, csr)   # the dense namespace must not densify
    assert not isinstance(csr, mx.nd.NDArray)
    assert "CSRNDArray" in repr(csr)


def _libsvm(tmp_path, rows=7, features=12, seed=0, name="data.libsvm"):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        cols = np.sort(rng.choice(features, rng.randint(0, 4), replace=False))
        lines.append(" ".join([str(rng.randint(0, 2))] + [
            f"{c}:{rng.rand():.4f}" for c in cols]))
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n\n")
    return str(p)


def _batches(m, **kwargs):
    it = m.io.LibSVMIter(**kwargs)
    out = [(b.data[0].asnumpy(), b.data[0].indptr.asnumpy(),
            b.label[0].asnumpy(), b.pad) for b in it]
    return it, out


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter(tmp_path, round_batch):
    p = tmp_path / "data.libsvm"
    p.write_text("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0 4:0.5\n0 0:2.0\n")
    from tpu_mx_torch.io import LibSVMIter
    batches = list(LibSVMIter(data_libsvm=str(p), data_shape=(5,),
                              batch_size=2))
    assert len(batches) == 2
    b0 = batches[0]
    assert b0.data[0].stype == "csr"
    expect = np.zeros((2, 5), np.float32)
    expect[0, 0], expect[0, 3] = 1.5, 2.0
    expect[1, 1] = 1.0
    np.testing.assert_array_equal(b0.data[0].asnumpy(), expect)
    np.testing.assert_array_equal(b0.label[0].asnumpy(), [1.0, 0.0])
    # a file whose last batch wraps, against the reference's batches
    path = _libsvm(tmp_path)
    kw = dict(data_libsvm=path, data_shape=(12,), batch_size=3,
              round_batch=round_batch)
    it, got = _batches(mx, **kw)
    jit, want = _batches(jmx, **kw)
    assert len(got) == len(want) == (3 if round_batch else 2)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    assert it.provide_data == [("data", (3, 12))]
    assert [tuple(d) for d in it.provide_label] == \
        [tuple(d) for d in jit.provide_label]


def test_libsvm_iter_labels_and_state(tmp_path):
    data = _libsvm(tmp_path)
    labels = _libsvm(tmp_path, features=3, seed=5, name="labels.libsvm")
    for kw in (dict(label_libsvm=labels, label_shape=(3,)),
               dict(label_shape=(2,))):
        kw.update(data_libsvm=data, data_shape=(12,), batch_size=4)
        _, got = _batches(mx, **kw)
        _, want = _batches(jmx, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])
    # state_dict: the reference's layout, and a restore resumes the stream
    it = mx.io.LibSVMIter(data_libsvm=data, data_shape=(12,), batch_size=2)
    next(it)
    state = it.state_dict()
    jit = jmx.io.LibSVMIter(data_libsvm=data, data_shape=(12,), batch_size=2)
    next(jit)
    assert state == jit.state_dict() == {"iter": "LibSVMIter", "version": 1,
                                         "cursor": 2}
    rest = [b.data[0].asnumpy() for b in it]
    fresh = mx.io.LibSVMIter(data_libsvm=data, data_shape=(12,), batch_size=2)
    fresh.load_state_dict(jit.state_dict())
    for a, b in zip(rest, [b.data[0].asnumpy() for b in fresh]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(mx.MXNetError, match="NDArrayIter"):
        fresh.load_state_dict({"iter": "NDArrayIter"})
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 0:1\n")
    for m in (mx, jmx):
        with pytest.raises(m.MXNetError, match="row count"):
            m.io.LibSVMIter(data_libsvm=data, data_shape=(12,), batch_size=2,
                            label_libsvm=str(bad))


def test_row_sparse_pull_matches_the_reference():
    value = np.arange(12, dtype=np.float32).reshape(4, 3)
    results = {}
    for m in (mx, jmx):
        kv = m.kv.create("local")
        kv.init(3, m.nd.array(value))
        out = m.nd.zeros((4, 3))
        kv.row_sparse_pull(3, out=out, row_ids=m.nd.array([1, 2]))
        results[m] = out.asnumpy()
        rsp = m.nd.sparse.zeros("row_sparse", (4, 3))
        with pytest.raises(TypeError, match="unsupported target"):
            kv.row_sparse_pull(3, out=rsp, row_ids=m.nd.array([1, 2]))
    np.testing.assert_array_equal(results[mx], results[jmx])
    np.testing.assert_array_equal(results[mx], value)


def test_attach_grad_sparse_stype_warns_and_stays_dense():
    for m in (mx, jmx):
        a = m.nd.array(np.ones((2, 3), np.float32))
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            a.attach_grad(stype="row_sparse")
        assert any("dense" in str(w.message) for w in seen)
        assert a.grad.stype == "default"
        np.testing.assert_array_equal(a.grad.asnumpy(), 0.0)
