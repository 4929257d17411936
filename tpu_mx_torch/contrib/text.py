"""``mx.contrib.text``, the port's own copy of ``tpu_mx/contrib/text.py``
(a module of numpy and the standard library): vocabularies and token
embeddings.

``count_tokens_from_str`` → :class:`Vocabulary` → embedding matrices
ready for ``nn.Embedding``/``ops.Embedding``.  :class:`CustomEmbedding`
loads the ``token<delim>v1<delim>...`` text format from a local file;
:class:`CompositeEmbedding` concatenates several over one vocabulary.
Embedding matrices are arrays on the current context (looked up through
one host copy).  Pretrained catalogues (GloVe, fastText) need a
download, which the port does not make: ``get_pretrained_file_names``
raises, as the reference's does.
"""
from __future__ import annotations

import collections
import re

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["count_tokens_from_str", "Vocabulary", "CustomEmbedding",
           "CompositeEmbedding", "get_pretrained_file_names"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token frequency counter (REF:contrib/text/utils.py)."""
    source_str = re.sub(re.escape(seq_delim), token_delim, source_str)
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(t for t in source_str.split(token_delim) if t)
    return counter


class Vocabulary:
    """Indexed vocabulary with reserved tokens; index 0 is the unknown
    token (REF:contrib/text/vocab.py Vocabulary)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if len(set(reserved_tokens)) != len(reserved_tokens) or \
                unknown_token in reserved_tokens:
            raise MXNetError("reserved tokens must be unique and must not "
                             "contain the unknown token")
        self._unknown_token = unknown_token
        self._idx_to_token = [unknown_token] + reserved_tokens
        self._reserved_tokens = reserved_tokens or None
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            taken = set(self._idx_to_token)
            # most_freq_count bounds COUNTER tokens only (reference
            # contract): unknown/reserved tokens ride on top
            budget = most_freq_count if most_freq_count is not None else None
            for tok, freq in pairs:
                if freq < min_freq or tok in taken:
                    continue
                if budget is not None and budget <= 0:
                    break
                self._idx_to_token.append(tok)
                taken.add(tok)
                if budget is not None:
                    budget -= 1
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        return idx[0] if single else idx

    def to_tokens(self, indices):
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self):
                raise MXNetError(f"token index {i} out of range")
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks


class _TokenEmbedding(Vocabulary):
    """Base: maps tokens to vectors; unknown tokens get init_unknown_vec."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec = None
        self._host_cache = None  # lazy host copy for token lookups

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def _load_embedding(self, path, elem_delim, init_unknown_vec,
                        encoding="utf8", restrict_to_vocab=False):
        tokens, vecs = [], []
        with open(path, encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if len(parts) <= 2:
                    continue  # header or malformed line (fastText header)
                tok, elems = parts[0], parts[1:]
                if restrict_to_vocab and tok not in self._token_to_idx:
                    continue  # vocabulary filter: don't index OOV file rows
                if self._vec_len and len(elems) != self._vec_len:
                    raise MXNetError(
                        f"line {line_num + 1}: dim {len(elems)} != "
                        f"{self._vec_len}")
                self._vec_len = self._vec_len or len(elems)
                tokens.append(tok)
                vecs.append(np.asarray(elems, np.float32))
        table = {t: v for t, v in zip(tokens, vecs)}
        if not restrict_to_vocab:
            for tok in tokens:
                if tok not in self._token_to_idx:
                    self._token_to_idx[tok] = len(self._idx_to_token)
                    self._idx_to_token.append(tok)
        mat = np.empty((len(self), self._vec_len), np.float32)
        unk = init_unknown_vec((self._vec_len,)) if init_unknown_vec \
            else np.zeros((self._vec_len,), np.float32)
        for i, tok in enumerate(self._idx_to_token):
            mat[i] = table.get(tok, unk)
        self._idx_to_vec = array(mat)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        if lower_case_backup:
            toks = [t if t in self._token_to_idx else t.lower()
                    for t in toks]
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        if self._host_cache is None:
            # one host copy, reused across lookups (a 400k-row table would
            # otherwise ride device->host on every call)
            self._host_cache = self._idx_to_vec.asnumpy()
        vecs = self._host_cache[idx]
        return array(vecs[0] if single else vecs)

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else tokens
        arr = new_vectors.asnumpy() if isinstance(new_vectors, NDArray) \
            else np.asarray(new_vectors, np.float32)
        arr = arr.reshape(len(toks), self._vec_len)
        mat = np.array(self._idx_to_vec.asnumpy())  # writable copy
        for t, v in zip(toks, arr):
            if t not in self._token_to_idx:
                raise MXNetError(f"token {t!r} is unknown; only known "
                                 "tokens can be updated")
            mat[self._token_to_idx[t]] = v
        self._idx_to_vec = array(mat)
        self._host_cache = None


class CustomEmbedding(_TokenEmbedding):
    """Embedding from a local `token<delim>v1<delim>...vn` text file
    (REF:contrib/text/embedding.py CustomEmbedding)."""

    def __init__(self, pretrained_file_path, elem_delim=" ", encoding="utf8",
                 init_unknown_vec=None, vocabulary=None, **kwargs):
        if vocabulary is not None:
            kwargs.setdefault("counter", collections.Counter(
                vocabulary.idx_to_token))
        super().__init__(**kwargs)
        if vocabulary is not None:
            self._idx_to_token = list(vocabulary.idx_to_token)
            self._token_to_idx = dict(vocabulary.token_to_idx)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec, encoding,
                             restrict_to_vocab=vocabulary is not None)


class CompositeEmbedding(_TokenEmbedding):
    """Concatenate several embeddings over one vocabulary
    (REF:contrib/text/embedding.py CompositeEmbedding)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, (list, tuple)):
            token_embeddings = [token_embeddings]
        self._unknown_token = vocabulary.unknown_token
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._reserved_tokens = vocabulary.reserved_tokens
        parts = [e.get_vecs_by_tokens(self._idx_to_token).asnumpy()
                 for e in token_embeddings]
        mat = np.concatenate(parts, axis=1)
        self._vec_len = mat.shape[1]
        self._idx_to_vec = array(mat)
        self._host_cache = None


def get_pretrained_file_names(embedding_name=None):
    """Raises, as the reference's does: the pretrained catalogues are
    downloads, which the port does not make.  Load local vectors with
    :class:`CustomEmbedding`."""
    raise MXNetError(
        "pretrained embedding downloads are not available to the port (it "
        "reads no network); load local vectors via "
        "contrib.text.CustomEmbedding(path) instead")
