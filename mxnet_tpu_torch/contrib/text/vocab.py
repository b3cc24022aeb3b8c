"""Text token indexing: counterpart of ``mxnet_tpu/contrib/text/vocab.py``
(reference: python/mxnet/contrib/text/vocab.py).

Pure-Python vocabulary: maps tokens <-> indices with frequency
thresholds. Index 0 is the unknown token; reserved tokens follow; then
counter keys sorted by frequency (ties broken alphabetically, matching
the reference's sort-then-stable-sort idiom, vocab.py:128-130).
"""
from __future__ import annotations

import collections

__all__ = ["Vocabulary"]


class Vocabulary:
    """Indexes text tokens (reference vocab.py:30).

    Parameters
    ----------
    counter : collections.Counter or None
        Token frequencies. None builds an empty vocabulary holding only
        the unknown and reserved tokens.
    most_freq_count : int or None
        Cap on the number of counter-derived tokens kept.
    min_freq : int
        Tokens rarer than this are dropped.
    unknown_token : str
        Representation for out-of-vocabulary tokens (index 0).
    reserved_tokens : list of str or None
        Tokens always kept (e.g. padding/bos/eos); must not duplicate
        the unknown token or each other.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("`min_freq` must be >= 1")
        if reserved_tokens is not None:
            reserved_set = set(reserved_tokens)
            if unknown_token in reserved_set:
                raise ValueError("`reserved_tokens` must not contain "
                                 "the unknown token")
            if len(reserved_set) != len(reserved_tokens):
                raise ValueError("`reserved_tokens` must not contain "
                                 "duplicates")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) \
            if reserved_tokens is not None else None
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in
                              enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        """(reference vocab.py:113-139): alphabetical sort then stable
        frequency sort gives freq-desc, alpha-asc tie-break."""
        if not isinstance(counter, collections.Counter):
            raise TypeError("`counter` must be a collections.Counter")
        special = set(self._idx_to_token)
        token_freqs = sorted(counter.items(), key=lambda x: x[0])
        token_freqs.sort(key=lambda x: x[1], reverse=True)
        cap = len(special) + (len(counter) if most_freq_count is None
                              else most_freq_count)
        for token, freq in token_freqs:
            if freq < min_freq or len(self._idx_to_token) == cap:
                break
            if token not in special:
                self._idx_to_token.append(token)
                self._token_to_idx[token] = len(self._idx_to_token) - 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index/indices; unknown tokens map to index 0
        (reference vocab.py:160)."""
        to_reduce = False
        if not isinstance(tokens, list):
            tokens = [tokens]
            to_reduce = True
        indices = [self._token_to_idx.get(t, 0) for t in tokens]
        return indices[0] if to_reduce else indices

    def to_tokens(self, indices):
        """Index/indices -> token(s) (reference vocab.py:187)."""
        to_reduce = False
        if not isinstance(indices, list):
            indices = [indices]
            to_reduce = True
        tokens = []
        for i in indices:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range [0, %d)"
                                 % (i, len(self._idx_to_token)))
            tokens.append(self._idx_to_token[i])
        return tokens[0] if to_reduce else tokens
