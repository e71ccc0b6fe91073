"""Text utilities: vocabulary + token embeddings.

Counterpart of `mxnet_tpu/contrib/text.py`, the reference's
`python/mxnet/contrib/text/`
(vocab.py Vocabulary; embedding.py register/create/
get_pretrained_file_names, _TokenEmbedding, GloVe, FastText,
CustomEmbedding, CompositeEmbedding; utils.py count_tokens_from_str;
_constants.py pretrained-file registry).

Divergence (documented): this build has zero egress, so pretrained files
are never downloaded. `GloVe`/`FastText` resolve
`embedding_root/<embedding_name>/<pretrained_file_name>` on the local
filesystem and raise a clear error telling the user where to place the
file when it is absent (the reference downloads from the Apache repo,
embedding.py:200). File-name registries mirror the reference's
`_constants.py` lists so `get_pretrained_file_names()` returns the same
catalogue.
"""
from __future__ import annotations

import collections
import os
import warnings

import numpy as _np

from ..base import MXNetError

__all__ = ["count_tokens_from_str", "Vocabulary", "register", "create",
           "get_pretrained_file_names", "TokenEmbedding", "GloVe",
           "FastText", "CustomEmbedding", "CompositeEmbedding"]

UNKNOWN_IDX = 0  # reference: contrib/text/_constants.py UNKNOWN_IDX


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """reference: contrib/text/utils.py count_tokens_from_str."""
    source_str = source_str.lower() if to_lower else source_str
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    for seq in filter(None, source_str.split(seq_delim)):
        counter.update(filter(None, seq.split(token_delim)))
    return counter


class Vocabulary:
    """Indexed vocabulary (reference: contrib/text/vocab.py Vocabulary)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise MXNetError("unknown_token cannot also be reserved")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq >= min_freq and tok != unknown_token \
                        and tok not in reserved_tokens:
                    self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

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
        """reference: vocab.py to_indices."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idx = [self._token_to_idx.get(t, UNKNOWN_IDX) for t in toks]
        return idx[0] if single else idx

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self):
                raise MXNetError("index %d out of vocabulary range" % i)
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks


# --------------------------------------------------------------------------
# Token-embedding registry (reference: embedding.py register/create/
# get_pretrained_file_names over mxnet.registry)
# --------------------------------------------------------------------------

_EMBEDDING_REGISTRY: dict = {}


def register(embedding_cls):
    """Register a TokenEmbedding subclass under its lower-cased class name
    (reference: embedding.py:40)."""
    if not (isinstance(embedding_cls, type)
            and issubclass(embedding_cls, TokenEmbedding)):
        raise MXNetError("register expects a TokenEmbedding subclass")
    _EMBEDDING_REGISTRY[embedding_cls.__name__.lower()] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    """Instantiate a registered embedding by (case-insensitive) name
    (reference: embedding.py:63)."""
    key = embedding_name.lower()
    if key not in _EMBEDDING_REGISTRY:
        raise KeyError(
            "Cannot find `embedding_name` %s. Valid embedding names: %s"
            % (embedding_name, ", ".join(sorted(_EMBEDDING_REGISTRY))))
    return _EMBEDDING_REGISTRY[key](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Valid embedding names and their pretrained file names
    (reference: embedding.py:90)."""
    if embedding_name is not None:
        key = embedding_name.lower()
        if key not in _EMBEDDING_REGISTRY:
            raise KeyError(
                "Cannot find `embedding_name` %s. Use "
                "`get_pretrained_file_names(embedding_name=None).keys()` "
                "to get all the valid embedding names." % embedding_name)
        return list(_EMBEDDING_REGISTRY[key].pretrained_file_name_sha1)
    return {name: list(cls.pretrained_file_name_sha1)
            for name, cls in _EMBEDDING_REGISTRY.items()}


class TokenEmbedding(Vocabulary):
    """Token embedding base (reference: embedding.py:133 _TokenEmbedding).

    Indexes tokens (it IS a Vocabulary) and maps each index to a vector
    row of `idx_to_vec`. Tokens either come from the loaded pretrained
    file, or — when a `vocabulary` is given — from that vocabulary, with
    vectors looked up in the loaded file."""

    #: pretrained file name -> sha1 (sha1 values are not tracked in this
    #: build — files are user-supplied locally, never downloaded)
    pretrained_file_name_sha1: dict = {}

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec = None

    # -- local pretrained-file resolution (no-egress divergence) ----------
    @classmethod
    def _get_pretrained_file(cls, embedding_root, pretrained_file_name):
        embedding_dir = os.path.join(os.path.expanduser(embedding_root),
                                     cls.__name__.lower())
        path = os.path.join(embedding_dir, pretrained_file_name)
        if not os.path.isfile(path):
            raise MXNetError(
                "pretrained embedding file %r not found under %s. This "
                "build never downloads (zero egress); obtain the file "
                "(reference URL scheme: embedding.py:191) and place it at "
                "that path." % (pretrained_file_name, embedding_dir))
        return path

    @classmethod
    def _check_pretrained_file_names(cls, pretrained_file_name):
        if pretrained_file_name not in cls.pretrained_file_name_sha1:
            raise KeyError(
                "Cannot find pretrained file %s for token embedding %s. "
                "Valid pretrained files for embedding %s: %s"
                % (pretrained_file_name, cls.__name__.lower(),
                   cls.__name__.lower(),
                   ", ".join(cls.pretrained_file_name_sha1)))

    # -- loading ----------------------------------------------------------
    def _load_embedding(self, pretrained_file_path, elem_delim,
                        init_unknown_vec, encoding="utf8"):
        """Parse `token<delim>v1<delim>...` lines into the index + vector
        table (reference: embedding.py:232). First occurrence of a token
        wins; 1-element lines (fasttext headers) are skipped; a vector for
        `unknown_token` in the file seeds index 0, else init_unknown_vec."""
        pretrained_file_path = os.path.expanduser(pretrained_file_path)
        if not os.path.isfile(pretrained_file_path):
            raise ValueError("`pretrained_file_path` must be a valid path "
                             "to the pre-trained token embedding file.")
        vec_len = None
        rows = []
        loaded_unknown_vec = None
        with open(pretrained_file_path, encoding=encoding) as f:
            for line_num, line in enumerate(f, 1):
                elems = line.rstrip().split(elem_delim)
                if len(elems) < 2:
                    continue
                token, vec = elems[0], [float(x) for x in elems[1:]]
                if token == self.unknown_token and loaded_unknown_vec is None:
                    loaded_unknown_vec = vec
                elif token in self._token_to_idx:
                    warnings.warn(
                        "line %d: duplicate embedding for token %r skipped"
                        % (line_num, token))
                elif len(vec) == 1:
                    warnings.warn(
                        "line %d: token %r with 1-dimensional vector %s is "
                        "likely a header and is skipped"
                        % (line_num, token, vec))
                else:
                    if vec_len is None:
                        vec_len = len(vec)
                    elif len(vec) != vec_len:
                        raise MXNetError(
                            "line %d: dimension of token %r is %d but "
                            "previous tokens have %d"
                            % (line_num, token, len(vec), vec_len))
                    self._idx_to_token.append(token)
                    self._token_to_idx[token] = len(self._idx_to_token) - 1
                    rows.append(vec)
        from .. import ndarray as nd

        if loaded_unknown_vec is not None:
            if vec_len is None:
                vec_len = len(loaded_unknown_vec)
            elif len(loaded_unknown_vec) != vec_len:
                raise MXNetError(
                    "the %r vector in %s has dimension %d but other tokens "
                    "have %d" % (self.unknown_token, pretrained_file_path,
                                 len(loaded_unknown_vec), vec_len))
        self._vec_len = vec_len or 0
        table = _np.zeros((len(self._idx_to_token), self._vec_len),
                          dtype=_np.float32)
        if rows:
            # vocabulary row 0 (+ reserved rows) precede the file tokens
            table[len(self._idx_to_token) - len(rows):] = _np.asarray(
                rows, dtype=_np.float32)
        if loaded_unknown_vec is not None:
            table[UNKNOWN_IDX] = _np.asarray(loaded_unknown_vec,
                                             dtype=_np.float32)
        elif init_unknown_vec is not None:
            table[UNKNOWN_IDX] = init_unknown_vec(
                shape=self._vec_len).asnumpy() \
                if callable(init_unknown_vec) else init_unknown_vec
        self._idx_to_vec = nd.array(table)

    # -- vocabulary re-indexing (reference: embedding.py:305,314,345) -----
    def _index_tokens_from_vocabulary(self, vocabulary):
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = list(vocabulary.reserved_tokens or [])

    def _set_idx_to_vec_by_embeddings(self, token_embeddings, vocab_len,
                                      vocab_idx_to_token):
        from .. import ndarray as nd

        new_vec_len = sum(e.vec_len for e in token_embeddings)
        table = _np.zeros((vocab_len, new_vec_len), dtype=_np.float32)
        col = 0
        for e in token_embeddings:
            end = col + e.vec_len
            table[0, col:end] = e.idx_to_vec[0].asnumpy()
            if vocab_len > 1:
                table[1:, col:end] = e.get_vecs_by_tokens(
                    vocab_idx_to_token[1:]).asnumpy()
            col = end
        self._vec_len = new_vec_len
        self._idx_to_vec = nd.array(table)

    def _build_embedding_for_vocabulary(self, vocabulary):
        if vocabulary is not None:
            if not isinstance(vocabulary, Vocabulary):
                raise MXNetError("`vocabulary` must be a "
                                 "contrib.text.Vocabulary instance")
            self._set_idx_to_vec_by_embeddings(
                [self], len(vocabulary), vocabulary.idx_to_token)
            self._index_tokens_from_vocabulary(vocabulary)

    # -- lookup / update --------------------------------------------------
    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """reference: embedding.py:366 — Embedding-op row gather."""
        from .. import ndarray as nd

        single = not isinstance(tokens, list)
        toks = [tokens] if single else tokens
        if lower_case_backup:
            indices = [self._token_to_idx.get(
                t, self._token_to_idx.get(t.lower(), UNKNOWN_IDX))
                for t in toks]
        else:
            indices = [self._token_to_idx.get(t, UNKNOWN_IDX) for t in toks]
        vecs = nd.Embedding(nd.array(indices),
                            self._idx_to_vec,
                            input_dim=self._idx_to_vec.shape[0],
                            output_dim=self._idx_to_vec.shape[1])
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        """reference: embedding.py:405 — in-place row updates for KNOWN
        tokens only (unknown tokens must be updated via unknown_token
        explicitly, to avoid unintended updates)."""
        from .. import ndarray as nd

        if self._idx_to_vec is None:
            raise MXNetError("`idx_to_vec` has not been set")
        toks = [tokens] if not isinstance(tokens, list) else tokens
        arr = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else _np.asarray(new_vectors, dtype=_np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.shape != (len(toks), self.vec_len):
            raise MXNetError(
                "new_vectors must have shape (%d, %d), got %s"
                % (len(toks), self.vec_len, arr.shape))
        indices = []
        for t in toks:
            if t not in self._token_to_idx:
                raise ValueError(
                    "Token %s is unknown. To update the embedding vector "
                    "for an unknown token, please specify it explicitly "
                    "as the `unknown_token` %s in `tokens`."
                    % (t, self._idx_to_token[UNKNOWN_IDX]))
            indices.append(self._token_to_idx[t])
        # asnumpy() may hand back a read-only view of the device buffer
        table = _np.array(self._idx_to_vec.asnumpy())
        table[indices] = arr
        self._idx_to_vec = nd.array(table)


# reference code subclasses the underscored name (embedding.py:133)
_TokenEmbedding = TokenEmbedding


def _default_unknown(shape):
    from .. import ndarray as nd

    return nd.zeros((shape,) if isinstance(shape, int) else shape)


# file catalogues mirroring reference _constants.py (names only — sha1
# hashes are download-validation data this no-egress build doesn't use)
_GLOVE_FILES = tuple(
    ["glove.42B.300d.txt", "glove.840B.300d.txt"]
    + ["glove.6B.%dd.txt" % d for d in (50, 100, 200, 300)]
    + ["glove.twitter.27B.%dd.txt" % d for d in (25, 50, 100, 200)])

_FAST_TEXT_LANGS = (
    "aa ab ace ady af ak als am ang an arc ar arz ast as av ay azb az bar "
    "bat_smg ba bcl be bg bh bi bjn bm bn bo bpy br bs bug bxr ca cbk_zam "
    "cdo ceb ce cho chr ch chy ckb co crh cr csb cs cu cv cy da de diq dsb "
    "dv dz ee el eml en eo es et eu ext fa ff fiu_vro fi fj fo frp frr fr "
    "fur fy gag gan ga gd glk gl gn gom got gu gv hak ha haw he hif hi ho "
    "hr hsb ht hu hy hz ia id ie ig ii ik ilo io is it iu jam ja jbo jv "
    "kaa kab ka kbd kg ki kj kk kl km kn koi ko krc kr ksh ks ku kv kw ky "
    "lad la lbe lb lez lg lij li lmo ln lo lrc ltg lt lv mai map_bms mdf "
    "mg mhr mh min mi mk ml mn mo mrj mr ms mt multi.ar multi.bg multi.ca "
    "multi.cs multi.da multi.de multi.el multi.en multi.es multi.et "
    "multi.fi multi.fr multi.he multi.hr multi.hu multi.id multi.it "
    "multi.mk multi.nl multi.no multi.pl multi.pt multi.ro multi.ru "
    "multi.sk multi.sl multi.sv multi.tr multi.uk multi.vi mus mwl my myv "
    "mzn nah nap na nds_nl nds ne new ng nl nn no nov nrm nso nv ny oc "
    "olo om or os pag pam pap pa pcd pdc pfl pih pi pl pms pnb pnt ps pt "
    "qu rm rmy rn roa_rup roa_tara ro rue ru rw sah sa scn sco sc sd se "
    "sg sh simple si sk sl sm sn so sq srn sr ss stq st su sv sw szl ta "
    "tcy tet te tg th ti tk tl tn to tpi tr ts tt tum tw ty tyv udm ug uk "
    "ur uz vec vep ve vi vls vo war wa wo wuu xal xh xmf yi yo za zea "
    "zh_classical zh_min_nan zh zh_yue zu").split()

_FAST_TEXT_FILES = tuple(
    ["wiki.%s.vec" % lang for lang in _FAST_TEXT_LANGS]
    + ["wiki-news-300d-1M.vec", "wiki-news-300d-1M-subword.vec",
       "crawl-300d-2M.vec"])


@register
class GloVe(TokenEmbedding):
    """GloVe word embeddings (reference: embedding.py:469). Loads a local
    `glove.*.txt` file from `embedding_root/glove/` (see module
    docstring for the no-download divergence)."""

    pretrained_file_name_sha1 = {f: None for f in _GLOVE_FILES}

    def __init__(self, pretrained_file_name="glove.840B.300d.txt",
                 embedding_root=os.path.join(
                     os.environ.get("MXNET_HOME",
                                    os.path.join("~", ".mxnet")),
                     "embeddings"),
                 init_unknown_vec=_default_unknown, vocabulary=None,
                 **kwargs):
        GloVe._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = GloVe._get_pretrained_file(embedding_root,
                                          pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        if vocabulary is not None:
            self._build_embedding_for_vocabulary(vocabulary)


@register
class FastText(TokenEmbedding):
    """fastText word embeddings (reference: embedding.py:541). Loads a
    local `wiki.*.vec` file from `embedding_root/fasttext/`."""

    pretrained_file_name_sha1 = {f: None for f in _FAST_TEXT_FILES}

    def __init__(self, pretrained_file_name="wiki.simple.vec",
                 embedding_root=os.path.join(
                     os.environ.get("MXNET_HOME",
                                    os.path.join("~", ".mxnet")),
                     "embeddings"),
                 init_unknown_vec=_default_unknown, vocabulary=None,
                 **kwargs):
        FastText._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = FastText._get_pretrained_file(embedding_root,
                                             pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        if vocabulary is not None:
            self._build_embedding_for_vocabulary(vocabulary)


class CustomEmbedding(TokenEmbedding):
    """Embedding matrix from a local `token vec...` text file (reference:
    embedding.py:623)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=_default_unknown,
                 vocabulary=None, **kwargs):
        if isinstance(init_unknown_vec, Vocabulary):
            # pre-r4 signature had (.., vocabulary, init_unknown_vec);
            # the reference order (embedding.py:656) now stands — rescue
            # old positional callers instead of failing opaquely
            warnings.warn("CustomEmbedding: a Vocabulary was passed where "
                          "init_unknown_vec goes; the signature follows "
                          "the reference order (path, elem_delim, "
                          "encoding, init_unknown_vec, vocabulary)")
            init_unknown_vec, vocabulary = _default_unknown, init_unknown_vec
        super().__init__(**kwargs)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec, encoding)
        if vocabulary is not None:
            self._build_embedding_for_vocabulary(vocabulary)

    @property
    def vocabulary(self):
        # pre-r4 compatibility: this class used to carry a separate
        # `vocabulary` attribute; it now IS the vocabulary
        return self


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings per token of a vocabulary
    (reference: embedding.py:665)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(vocabulary, Vocabulary):
            raise MXNetError("`vocabulary` must be a "
                             "contrib.text.Vocabulary instance")
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        for e in token_embeddings:
            if not isinstance(e, TokenEmbedding):
                raise MXNetError("`token_embeddings` must be TokenEmbedding "
                                 "instance(s)")
        super().__init__()
        self._index_tokens_from_vocabulary(vocabulary)
        self._set_idx_to_vec_by_embeddings(token_embeddings, len(self),
                                           self.idx_to_token)
