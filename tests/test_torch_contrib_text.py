"""``contrib.text`` of the port against the JAX package's, on the same
inputs (token strings, counters and local embedding files written here).

Every comparison is exact: the vocabularies' ``idx_to_token`` and
``token_to_idx`` equal, and every embedding matrix (``CustomEmbedding``,
``GloVe``, ``FastText``, ``CompositeEmbedding``, after
``update_token_vectors``) bit for bit, since both packages parse the
same text into float32 on the host and only gather rows. The port's
NDArrays land on the context it is asked for (``mx.cpu()`` here).
"""
import collections

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import text as jtext
from mxnet_tpu_torch.contrib import text as ttext

torch.set_num_threads(2)

C = mx.cpu()

CORPUS = ("the quick brown fox jumps over the lazy dog\n"
          "The Dog barks and the fox runs\nquick quick brown dogs run")


def _write(path, lines):
    with open(path, "w") as f:
        f.write("".join(line + "\n" for line in lines))
    return str(path)


def _vectors(n, dim, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, dim)).astype(np.float32)


def _embedding_file(path, tokens, dim, seed, header=False):
    vecs = _vectors(len(tokens), dim, seed)
    lines = ["%d %d" % (len(tokens), dim)] if header else []
    lines += [t + " " + " ".join(repr(float(x)) for x in v)
              for t, v in zip(tokens, vecs)]
    return _write(path, lines)


def _same_vocab(a, b):
    assert a.idx_to_token == b.idx_to_token
    assert a.token_to_idx == b.token_to_idx
    assert a.unknown_token == b.unknown_token
    assert a.reserved_tokens == b.reserved_tokens
    assert len(a) == len(b)


def _same_matrix(jemb, temb):
    with C:
        got = temb.idx_to_vec
    assert got.context == C
    want = jemb.idx_to_vec.asnumpy()
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert got.dtype == np.float32


@pytest.mark.parametrize("kwargs", [
    {},
    {"to_lower": True},
    {"token_delim": "o", "seq_delim": "\n"},
])
def test_count_tokens_from_str_is_the_jax_packages(kwargs):
    assert ttext.utils.count_tokens_from_str(CORPUS, **kwargs) == \
        jtext.utils.count_tokens_from_str(CORPUS, **kwargs)
    base = collections.Counter({"fox": 5})
    got = ttext.utils.count_tokens_from_str(CORPUS, counter_to_update=
                                            collections.Counter(base))
    want = jtext.utils.count_tokens_from_str(CORPUS, counter_to_update=
                                             collections.Counter(base))
    assert got == want


@pytest.mark.parametrize("kwargs", [
    {},
    {"min_freq": 2},
    {"most_freq_count": 3, "reserved_tokens": ["<pad>", "<bos>"]},
    {"unknown_token": "<oov>", "reserved_tokens": ["<eos>"], "min_freq": 1},
])
def test_vocabulary_is_the_jax_packages(kwargs):
    counter = jtext.utils.count_tokens_from_str(CORPUS, to_lower=True)
    tv = ttext.Vocabulary(counter, **kwargs)
    jv = jtext.Vocabulary(counter, **kwargs)
    _same_vocab(tv, jv)
    probe = ["the", "fox", "unseen", "dog"]
    assert tv.to_indices(probe) == jv.to_indices(probe)
    assert tv.to_indices("quick") == jv.to_indices("quick")
    idx = list(range(len(tv)))
    assert tv.to_tokens(idx) == jv.to_tokens(idx)


def test_vocabulary_errors_are_the_jax_packages():
    for pkg in (ttext, jtext):
        with pytest.raises(ValueError):
            pkg.Vocabulary(min_freq=0)
        with pytest.raises(ValueError):
            pkg.Vocabulary(reserved_tokens=["<unk>"])
        with pytest.raises(ValueError):
            pkg.Vocabulary(reserved_tokens=["a", "a"])
        with pytest.raises(TypeError):
            pkg.Vocabulary(counter={"a": 1})
        with pytest.raises(ValueError, match="out of range"):
            pkg.Vocabulary().to_tokens(5)


@pytest.mark.parametrize("cls,name,header", [
    ("CustomEmbedding", "my_vectors.txt", False),
    ("GloVe", "glove.6B.50d.txt", False),
    ("FastText", "wiki.simple.vec", True),
])
def test_embeddings_load_bit_for_bit(tmp_path, cls, name, header):
    tokens = ["the", "fox", "dog", "<unk>", "quick", "the", "run"]
    path = _embedding_file(tmp_path / name, tokens, 6, seed=3,
                           header=header)
    temb = getattr(ttext.embedding, cls)(pretrained_file_path=path)
    jemb = getattr(jtext.embedding, cls)(pretrained_file_path=path)
    _same_vocab(temb, jemb)
    assert temb.vec_len == jemb.vec_len == 6
    _same_matrix(jemb, temb)
    probe = ["fox", "missing", "<$_unk_$>", "dog"]
    with C:
        got = temb.get_vecs_by_tokens(probe)
        one = temb.get_vecs_by_tokens("quick")
    assert got.context == C and one.context == C
    np.testing.assert_array_equal(
        got.asnumpy(), jemb.get_vecs_by_tokens(probe).asnumpy())
    np.testing.assert_array_equal(
        one.asnumpy(), jemb.get_vecs_by_tokens("quick").asnumpy())
    with C:
        low = temb.get_vecs_by_tokens(["FOX", "Dog"], lower_case_backup=True)
    np.testing.assert_array_equal(
        low.asnumpy(), jemb.get_vecs_by_tokens(
            ["FOX", "Dog"], lower_case_backup=True).asnumpy())


def test_custom_embedding_options_and_vocabulary(tmp_path):
    tokens = ["alpha", "beta", "gamma", "delta"]
    vecs = _vectors(4, 3, seed=5)
    path = _write(tmp_path / "v.tsv",
                  [t + "\t" + "\t".join(repr(float(x)) for x in v)
                   for t, v in zip(tokens, vecs)] + ["bad", "eps\t1\t2"])
    counter = collections.Counter(["gamma", "gamma", "alpha", "zeta"])
    jvocab = jtext.Vocabulary(counter, reserved_tokens=["<pad>"])
    tvocab = ttext.Vocabulary(counter, reserved_tokens=["<pad>"])

    def ones(n):
        return np.ones(n, np.float32)

    temb = ttext.embedding.CustomEmbedding(
        path, elem_delim="\t", init_unknown_vec=ones, vocabulary=tvocab)
    jemb = jtext.embedding.CustomEmbedding(
        path, elem_delim="\t", init_unknown_vec=ones, vocabulary=jvocab)
    _same_vocab(temb, jemb)
    _same_matrix(jemb, temb)


def test_composite_embedding_and_update_bit_for_bit(tmp_path):
    f1 = _embedding_file(tmp_path / "a.txt", ["fox", "dog", "the"], 4, 7)
    f2 = _embedding_file(tmp_path / "glove.6B.50d.txt",
                         ["dog", "quick", "brown"], 3, 8)
    counter = jtext.utils.count_tokens_from_str(CORPUS, to_lower=True)
    tv = ttext.Vocabulary(counter, min_freq=2)
    jv = jtext.Vocabulary(counter, min_freq=2)
    tcomp = ttext.embedding.CompositeEmbedding(
        tv, [ttext.embedding.CustomEmbedding(f1),
             ttext.embedding.GloVe(pretrained_file_path=f2)])
    jcomp = jtext.embedding.CompositeEmbedding(
        jv, [jtext.embedding.CustomEmbedding(f1),
             jtext.embedding.GloVe(pretrained_file_path=f2)])
    _same_vocab(tcomp, jcomp)
    assert tcomp.vec_len == jcomp.vec_len == 7
    _same_matrix(jcomp, tcomp)

    new = np.arange(14, dtype=np.float32).reshape(2, 7) / 7.0
    with C:
        tcomp.update_token_vectors(["the", "fox"], mx.nd.array(new))
    jcomp.update_token_vectors(["the", "fox"], jmx.nd.array(new))
    tcomp.update_token_vectors("dog", new[0])
    jcomp.update_token_vectors("dog", new[0])
    _same_matrix(jcomp, tcomp)


def test_registry_and_errors_are_the_jax_packages(tmp_path):
    assert ttext.embedding.get_pretrained_file_names() == \
        jtext.embedding.get_pretrained_file_names()
    for name in ("glove", "FastText", "customembedding"):
        assert ttext.embedding.get_pretrained_file_names(name) == \
            jtext.embedding.get_pretrained_file_names(name)
    path = _embedding_file(tmp_path / "wiki.en.vec", ["a", "b"], 2, 1,
                           header=True)
    temb = ttext.embedding.create("fasttext", pretrained_file_path=path)
    jemb = jtext.embedding.create("fasttext", pretrained_file_path=path)
    assert type(temb).__name__ == type(jemb).__name__ == "FastText"
    _same_matrix(jemb, temb)
    for pkg in (ttext, jtext):
        with pytest.raises(KeyError, match="unknown embedding"):
            pkg.embedding.create("word2vec")
        with pytest.raises(ValueError, match="valid path"):
            pkg.embedding.GloVe(
                pretrained_file_path=str(tmp_path / "glove.6B.100d.txt"))
    with pytest.raises(ValueError, match="unknown"):
        temb.update_token_vectors("zzz", np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="unknown"):
        jemb.update_token_vectors("zzz", np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="empty"):
        ttext.embedding.TokenEmbedding().update_token_vectors("a", [1.0])


def test_embedding_weight_from_idx_to_vec(tmp_path):
    """A gluon ``Embedding`` whose weight is set from ``idx_to_vec``
    returns the matrix's rows, bit for bit."""
    path = _embedding_file(tmp_path / "e.txt", ["x", "y", "z"], 5, 11)
    emb = ttext.embedding.CustomEmbedding(path)
    layer = mx.gluon.nn.Embedding(len(emb), emb.vec_len)
    layer.initialize(ctx=C)
    with C:
        layer.weight.set_data(emb.idx_to_vec)
        ids = mx.nd.array(emb.to_indices(["z", "nope", "x"]))
        out = layer(ids)
    np.testing.assert_array_equal(
        out.asnumpy(), emb._idx_to_vec[[3, 0, 1]])


def test_the_raise_is_gone():
    """``mx.contrib.text`` and ``mx.contrib.svrg_optimization`` import,
    and the lazy names resolve to the modules."""
    assert mx.contrib.text is ttext
    from mxnet_tpu_torch.contrib import svrg_optimization

    assert mx.contrib.svrg_optimization is svrg_optimization
    assert mx.contrib.svrg_optimization.SVRGModule.__module__ == \
        "mxnet_tpu_torch.contrib.svrg_optimization.svrg_module"
    with pytest.raises(AttributeError):
        mx.contrib.no_such_package
