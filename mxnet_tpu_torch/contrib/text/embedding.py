"""Token embeddings: counterpart of
``mxnet_tpu/contrib/text/embedding.py`` (reference:
python/mxnet/contrib/text/embedding.py).

Loads pretrained word vectors into an index-aligned matrix, kept as a
host numpy array. `idx_to_vec` and `get_vecs_by_tokens` hand out
NDArrays on the current context (``gpu(0)`` unless the caller asks for
the CPU). Zero-egress adaptation: the reference downloads GloVe/fastText
archives at construction; here every embedding class loads from a LOCAL
pretrained file (`pretrained_file_path`). The rest of the surface —
`register`/`create`, vocabulary composition, `get_vecs_by_tokens`,
`update_token_vectors`, `CompositeEmbedding` — follows the reference.
"""
from __future__ import annotations

import io
import logging
import os

import numpy as np

from . import vocab as _vocab

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "CustomEmbedding", "GloVe", "FastText",
           "CompositeEmbedding"]

_REGISTRY = {}


def register(embedding_cls):
    """Register a TokenEmbedding subclass under its lowercase name
    (reference embedding.py:40)."""
    _REGISTRY[embedding_cls.__name__.lower()] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    """Instantiate a registered embedding (reference embedding.py:63)."""
    try:
        cls = _REGISTRY[embedding_name.lower()]
    except KeyError:
        raise KeyError("unknown embedding %r; registered: %s"
                       % (embedding_name, sorted(_REGISTRY))) from None
    return cls(**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Reference embedding.py:90. Zero-egress: no hosted archives; the
    answer enumerates what each class would accept."""
    names = {name: cls.pretrained_file_names
             for name, cls in _REGISTRY.items()}
    if embedding_name is not None:
        return names[embedding_name.lower()]
    return names


class TokenEmbedding(_vocab.Vocabulary):
    """Base embedding: a Vocabulary whose indices align with rows of
    `idx_to_vec` (reference embedding.py:133 `_TokenEmbedding`)."""

    pretrained_file_names = ()

    def __init__(self, unknown_token="<unk>", **kwargs):
        super().__init__(counter=None, unknown_token=unknown_token,
                         **kwargs)
        self._vec_len = 0
        self._idx_to_vec = None

    # -- loading -------------------------------------------------------------

    def _load_embedding(self, pretrained_file_path, elem_delim=" ",
                        init_unknown_vec=np.zeros, encoding="utf8"):
        """Parse `token<delim>v1<delim>...vN` lines
        (reference embedding.py:232)."""
        if not os.path.isfile(pretrained_file_path):
            raise ValueError(
                "`pretrained_file_path` must be a valid path to the "
                "pretrained token embedding file (zero-egress build: "
                "files are never downloaded): %r" % pretrained_file_path)
        vecs = []
        with io.open(pretrained_file_path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                elems = line.rstrip().split(elem_delim)
                if len(elems) <= 1:
                    logging.warning("line %d of %s: unexpected format, "
                                    "skipped", line_num,
                                    pretrained_file_path)
                    continue
                token, vec = elems[0], elems[1:]
                if len(vec) == 1:   # fastText-style header line
                    continue
                if token == self.unknown_token:
                    token = "<$_unk_$>"  # reference renames clashes
                if token in self._token_to_idx:
                    continue
                if self._vec_len == 0:
                    self._vec_len = len(vec)
                elif len(vec) != self._vec_len:
                    logging.warning("line %d of %s: dim %d != %d, "
                                    "skipped", line_num,
                                    pretrained_file_path, len(vec),
                                    self._vec_len)
                    continue
                self._idx_to_token.append(token)
                self._token_to_idx[token] = len(self._idx_to_token) - 1
                vecs.append(np.asarray(vec, dtype=np.float32))
        mat = np.zeros((len(self), self._vec_len), dtype=np.float32)
        n_special = len(self) - len(vecs)
        # Every non-pretrained row (unknown + all reserved tokens) gets
        # the unknown initializer, matching the reference's behavior
        # (embedding.py: loaded_unknown_vec applies to each such row).
        mat[:n_special] = init_unknown_vec(self._vec_len)
        if vecs:
            mat[n_special:] = np.stack(vecs)
        self._idx_to_vec = mat

    def _build_from_vocabulary(self, vocabulary, *sources):
        """Re-index rows to a user vocabulary
        (reference embedding.py:305-357). One fancy-index gather per
        source — not a per-token Python loop, which would take minutes
        on a real (100k+ token) vocabulary."""
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = vocabulary.reserved_tokens
        self._vec_len = sum(s.vec_len for s in sources)
        mat = np.zeros((len(self), self._vec_len), dtype=np.float32)
        col = 0
        for s in sources:
            idx = [s._tok.get(t, 0) for t in self._idx_to_token]
            mat[:, col:col + s.vec_len] = s._emb_mat[idx]
            col += s.vec_len
        self._idx_to_vec = mat

    # -- queries -------------------------------------------------------------

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        """The embedding matrix as an NDArray on the current context."""
        from ... import ndarray as nd

        return None if self._idx_to_vec is None \
            else nd.array(self._idx_to_vec)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Vectors for token(s), an NDArray on the current context;
        unknown tokens get row 0 (reference embedding.py:366)."""
        from ... import ndarray as nd

        to_reduce = False
        if not isinstance(tokens, list):
            tokens = [tokens]
            to_reduce = True

        def idx_of(t):
            if t in self._token_to_idx:
                return self._token_to_idx[t]
            if lower_case_backup:
                return self._token_to_idx.get(t.lower(), 0)
            return 0

        rows = self._idx_to_vec[[idx_of(t) for t in tokens]]
        out = nd.array(rows if not to_reduce else rows[0])
        return out

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite rows for known tokens (reference embedding.py:405)."""
        if self._idx_to_vec is None:
            raise ValueError("embedding matrix is empty")
        if not isinstance(tokens, list):
            tokens = [tokens]
        arr = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else np.asarray(new_vectors, dtype=np.float32)
        arr = arr.reshape(len(tokens), -1)
        for t, v in zip(tokens, arr):
            if t not in self._token_to_idx:
                raise ValueError(
                    "token %r is unknown; only tokens in the vocabulary "
                    "can be updated" % t)
            self._idx_to_vec[self._token_to_idx[t]] = v


@register
class CustomEmbedding(TokenEmbedding):
    """Embedding from a user file `token<delim>v1...vN`
    (reference embedding.py:893)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=np.zeros,
                 vocabulary=None, **kwargs):
        super().__init__(**kwargs)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec, encoding)
        if vocabulary is not None:
            src = self
            self._build_from_vocabulary(vocabulary, _Frozen(src))


class _Frozen:
    """Read-only (matrix, token-index) view used during vocabulary
    re-indexing — decoupled from the source embedding so CustomEmbedding
    can re-index over ITSELF."""

    def __init__(self, emb):
        self.vec_len = emb.vec_len
        self._emb_mat = emb._idx_to_vec.copy()
        self._tok = dict(emb._token_to_idx)


@register
class GloVe(CustomEmbedding):
    """GloVe vectors from a LOCAL `glove.*.txt` file (the reference
    downloads from the Stanford NLP archive, embedding.py:469;
    zero-egress builds must supply the file)."""

    pretrained_file_names = ("glove.42B.300d.txt", "glove.6B.50d.txt",
                             "glove.6B.100d.txt", "glove.6B.200d.txt",
                             "glove.6B.300d.txt", "glove.840B.300d.txt",
                             "glove.twitter.27B.25d.txt")


@register
class FastText(CustomEmbedding):
    """fastText vectors from a LOCAL `.vec` file (reference
    embedding.py:560 downloads; header lines are skipped)."""

    pretrained_file_names = ("wiki.simple.vec", "wiki.en.vec")


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings over one vocabulary
    (reference embedding.py:813)."""

    def __init__(self, vocabulary, token_embeddings):
        super().__init__(unknown_token=vocabulary.unknown_token)
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        self._build_from_vocabulary(
            vocabulary, *[_Frozen(e) for e in token_embeddings])
