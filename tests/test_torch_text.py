"""The port's ``contrib.text`` against the reference's, on the CPU: each
test of ``tests/test_text.py`` with the reference beside it.  The
embedding files are written by the tests (seeded vectors); no
pretrained file is read.

Tolerances: counters, vocabularies, indices and tokens are equal;
embedding matrices are equal bit for bit (both packages parse the same
text into float32).  ``get_pretrained_file_names`` raises in both, as
the reference's test pins (``tests/test_text.py:90``); the texts name
each package's reason.
"""
import collections

import numpy as np
import pytest

from tpu_mx.base import MXNetError as JError
from tpu_mx.contrib import text as jtext

import tpu_mx_torch as mx
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import text

PKGS = {"ref": (jtext, JError), "port": (text, MXNetError)}


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


@pytest.mark.parametrize("src,kw", [
    ("a b b\nc c c", {}), ("A a", {"to_lower": True}),
    ("a.b c", {"seq_delim": "."}), ("x,y;;x", {"token_delim": ",",
                                               "seq_delim": ";"})])
def test_count_tokens(src, kw):
    got = text.count_tokens_from_str(src, **kw)
    assert got == jtext.count_tokens_from_str(src, **kw)
    assert isinstance(got, collections.Counter)
    upd = collections.Counter({"a": 5})
    assert text.count_tokens_from_str(src, counter_to_update=upd, **kw) \
        is upd


def test_count_tokens_regex_delim_escaped():
    assert text.count_tokens_from_str("a.b c", seq_delim=".") == \
        {"a": 1, "b": 1, "c": 1}


@pytest.mark.parametrize("kw", [
    {"reserved_tokens": ["<pad>"]}, {"most_freq_count": 3},
    {"min_freq": 2}, {"unknown_token": "UNK", "most_freq_count": 0},
    {"reserved_tokens": ["<s>", "</s>"], "min_freq": 3}])
def test_vocabulary_order_and_limits(kw):
    c = text.count_tokens_from_str("a b b c c c d e e")
    v, jv = text.Vocabulary(c, **kw), jtext.Vocabulary(c, **kw)
    assert v.idx_to_token == jv.idx_to_token
    assert v.token_to_idx == jv.token_to_idx
    assert (v.unknown_token, v.reserved_tokens, len(v)) == \
        (jv.unknown_token, jv.reserved_tokens, len(jv))
    toks = ["c", "zzz", "b"]
    assert v.to_indices(toks) == jv.to_indices(toks)
    assert v.to_indices("zzz") == 0
    assert v.to_tokens(list(range(len(v)))) == v.idx_to_token


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_vocabulary_refuses_what_the_reference_refuses(pkg):
    lib, err = PKGS[pkg]
    c = lib.count_tokens_from_str("a b")
    with pytest.raises(err):
        lib.Vocabulary(c, reserved_tokens=["<unk>"])
    with pytest.raises(err):
        lib.Vocabulary(c, reserved_tokens=["x", "x"])
    with pytest.raises(err):
        lib.Vocabulary(c, min_freq=0)
    with pytest.raises(err, match="out of range"):
        lib.Vocabulary(c).to_tokens(7)


def _write(tmp_path, name, rows):
    p = tmp_path / name
    p.write_text("".join(f"{t} {' '.join(map(str, v))}\n" for t, v in rows))
    return str(p)


def _seeded_vecs(tmp_path, n=6, dim=4, seed=0, header=False):
    rng = np.random.RandomState(seed)
    rows = [(f"tok{i}", np.round(rng.randn(dim), 6)) for i in range(n)]
    p = tmp_path / f"vecs{seed}.txt"
    lines = [f"{n} {dim}\n"] if header else []   # fastText's header line
    lines += [f"{t} {' '.join(repr(float(x)) for x in v)}\n"
              for t, v in rows]
    p.write_text("".join(lines))
    return str(p), rows


@pytest.mark.parametrize("header", [False, True])
def test_custom_embedding(tmp_path, header):
    path, rows = _seeded_vecs(tmp_path, header=header)
    emb, jemb = text.CustomEmbedding(path), jtext.CustomEmbedding(path)
    assert emb.vec_len == jemb.vec_len == 4
    assert emb.idx_to_token == jemb.idx_to_token
    np.testing.assert_array_equal(emb.idx_to_vec.asnumpy(),
                                  jemb.idx_to_vec.asnumpy())
    toks = ["tok3", "missing", "tok0"]
    np.testing.assert_array_equal(emb.get_vecs_by_tokens(toks).asnumpy(),
                                  jemb.get_vecs_by_tokens(toks).asnumpy())
    np.testing.assert_array_equal(
        emb.get_vecs_by_tokens("TOK1", lower_case_backup=True).asnumpy(),
        np.asarray(rows[1][1], np.float32))
    new = np.array([9.0, 8.0, 7.0, 6.0])
    for e in (emb, jemb):
        e.update_token_vectors("tok2", new)
    np.testing.assert_array_equal(emb.idx_to_vec.asnumpy(),
                                  jemb.idx_to_vec.asnumpy())
    with pytest.raises(MXNetError):
        emb.update_token_vectors("nope", np.zeros(4))


def test_custom_embedding_refuses_a_ragged_file(tmp_path):
    p = _write(tmp_path, "bad.txt", [("a", [1, 2, 3]), ("b", [1, 2])])
    for lib, err in PKGS.values():
        with pytest.raises(err, match="line 2"):
            lib.CustomEmbedding(p)


def test_embedding_with_vocabulary(tmp_path):
    path = _write(tmp_path, "vecs.txt", [("hello", [1, 2, 3]),
                                         ("world", [4, 5, 6])])
    got = []
    for lib, _ in (PKGS["ref"], PKGS["port"]):
        v = lib.Vocabulary(lib.count_tokens_from_str("hello hello unseen"))
        emb = lib.CustomEmbedding(path, vocabulary=v, init_unknown_vec=np.ones)
        assert len(emb) == len(v) and "world" not in emb.token_to_idx
        got.append((emb.idx_to_token, emb.idx_to_vec.asnumpy()))
    assert got[1][0] == got[0][0]
    np.testing.assert_array_equal(got[1][1], got[0][1])
    np.testing.assert_array_equal(got[1][1][got[1][0].index("unseen")],
                                  [1, 1, 1])


def test_composite_embedding(tmp_path):
    p1, _ = _seeded_vecs(tmp_path, seed=1)
    p2, _ = _seeded_vecs(tmp_path, dim=2, seed=2)
    got = []
    for lib, _ in (PKGS["ref"], PKGS["port"]):
        v = lib.Vocabulary(lib.count_tokens_from_str("tok1 tok4 other tok1"))
        comp = lib.CompositeEmbedding(v, [lib.CustomEmbedding(p1),
                                          lib.CustomEmbedding(p2)])
        got.append((comp.vec_len, comp.idx_to_token,
                    comp.idx_to_vec.asnumpy(),
                    comp.get_vecs_by_tokens("tok4").asnumpy()))
    assert got[1][:2] == got[0][:2] and got[1][0] == 6
    for a, b in zip(got[1][2:], got[0][2:]):
        np.testing.assert_array_equal(a, b)


def test_pretrained_catalog_documented_divergence():
    with pytest.raises(JError, match="hermetic"):
        jtext.get_pretrained_file_names("glove")
    with pytest.raises(MXNetError, match="CustomEmbedding"):
        text.get_pretrained_file_names("glove")
    with pytest.raises(MXNetError, match="download"):
        text.get_pretrained_file_names()


def test_embedding_matrix_feeds_an_embedding_layer(tmp_path):
    """``idx_to_vec`` is ready for ``nn.Embedding``: rows by index."""
    from tpu_mx_torch.gluon import nn
    path, rows = _seeded_vecs(tmp_path)
    emb = text.CustomEmbedding(path)
    layer = nn.Embedding(len(emb), emb.vec_len)
    layer.initialize()
    layer.weight.set_data(emb.idx_to_vec)
    ids = mx.nd.array(np.array(emb.to_indices(["tok5", "tok0"]),
                               np.float32))
    np.testing.assert_array_equal(layer(ids).asnumpy(),
                                  np.asarray([rows[5][1], rows[0][1]],
                                             np.float32))
