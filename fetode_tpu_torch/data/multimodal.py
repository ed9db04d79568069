"""Multimodal text fusion for Time-MMD forecasting (counterpart of
``fetode_tpu/data/multimodal.py``).

Join the numeric series with report / search text on (start_date,
end_date), build one combined text field, embed it with a train-only
TF-IDF (1-2-grams, at most 20,000 features) and truncated SVD, and
concatenate the embedding with the numeric features.

The JAX package calls pandas and sklearn; the port does the same steps
on the tables of ``data/columns.py`` with numpy and scipy:

* ``tfidf_fit`` / ``Tfidf.transform``: sklearn 1.9's ``TfidfVectorizer``
  at its defaults (lower case, token pattern ``(?u)\\b\\w\\w+\\b``,
  n-grams, ``min_df``, ``max_df`` 1.0, ``max_features`` cut by total
  count with numpy's default argsort on the name-sorted vocabulary, as
  sklearn's ``_limit_features`` cuts, smooth idf, l2 rows).
* ``svd_fit``: ``TruncatedSVD``'s randomized solver (5 power iterations
  normalised by scipy's LU, 10 oversamples, the Gaussian test matrix from
  ``np.random.RandomState(seed)``, the economic QR and SVD of scipy, the
  signs of ``svd_flip(u_based_decision=False)``), so the embedding is the
  same one, not merely the same subspace.

A host-side preprocessing stage: its output is a frozen (N, F_num +
text_dim) array that enters training like any other feature matrix.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import scipy.linalg
import scipy.sparse

from fetode_tpu_torch.data.columns import (
    Table,
    isna,
    sort_order,
    take,
    to_datetime,
)

_TOKEN = re.compile(r"(?u)\b\w\w+\b")


def _missing_like(values: np.ndarray, n: int) -> np.ndarray:
    if np.issubdtype(values.dtype, np.datetime64):
        return np.full(n, np.datetime64("NaT"), values.dtype)
    if np.issubdtype(values.dtype, np.number):
        return np.full(n, np.nan)
    return np.full(n, None, object)


def _key(values: np.ndarray) -> list:
    """Join keys, missing dates equal to each other as in pandas' merge."""
    if np.issubdtype(values.dtype, np.datetime64):
        return values.astype("datetime64[ns]").view(np.int64).tolist()
    return list(values)


def _merge_left(left: Table, right: Table, on: Sequence[str],
                suffixes: Tuple[str, str]) -> Table:
    """``left.merge(right, on=on, how="left", suffixes=suffixes)``: every
    left row once per matching right row (in right's order), or once with
    missing right columns."""
    index: Dict[tuple, list] = {}
    for j, k in enumerate(zip(*(_key(right[c]) for c in on))):
        index.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(zip(*(_key(left[c]) for c in on))):
        for j in index.get(k, [-1]):
            li.append(i)
            ri.append(j)
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    hit = ri >= 0
    extra = [c for c in right if c not in on]
    out: Table = {}
    for c, v in left.items():
        name = c + suffixes[0] if c in extra and c not in on else c
        out[name] = v[li]
    for c in extra:
        v = right[c]
        col = _missing_like(v, len(ri))
        col[hit] = v[ri[hit]]
        out[c + suffixes[1] if c in left else c] = col
    return out


def _yyyymmdd(values: np.ndarray) -> np.ndarray:
    """``pd.to_datetime(col.astype(str), format="%Y%m%d",
    errors="coerce")``."""
    out = np.full(len(values), np.datetime64("NaT"), "datetime64[ns]")
    for i, v in enumerate(values):
        s = str(v)
        if re.fullmatch(r"\d{8}", s):
            try:
                out[i] = np.datetime64(f"{s[:4]}-{s[4:6]}-{s[6:]}", "ns")
            except ValueError:
                pass
    return out


def merge_with_text(numeric: Table, report: Table, search: Table,
                    join_cols: Sequence[str] = ("start_date", "end_date"),
                    text_cols: Sequence[str] = ("fact", "preds"),
                    date_col: str = "date") -> Table:
    """Left-join report and search text onto the numeric table and build
    a single combined ``text`` field per row; sorted by ``date_col``
    (``MapDate`` read as YYYYMMDD when present, else ``start_date``)."""
    tables = []
    for t in (numeric, report, search):
        t = dict(t)
        for c in list(join_cols) + ["ValidStart", "ValidEnd"]:
            if c in t:
                t[c] = to_datetime(t[c])
        tables.append(t)
    numeric, report, search = tables
    for src, dst in (("ValidStart", "start_date"), ("ValidEnd", "end_date")):
        if dst not in numeric and src in numeric:
            numeric[dst] = numeric[src]

    def small(t):
        return {c: t[c] for c in list(join_cols) + list(text_cols)}

    merged = _merge_left(numeric, small(report), join_cols, ("", "_report"))
    merged = _merge_left(merged, small(search), join_cols, ("", "_search"))

    def s(col):
        miss = isna(merged[col])
        return ["" if m else str(v) for v, m in zip(merged[col], miss)]

    merged["text"] = np.asarray(
        [f"REPORT_FACT: {a}\nREPORT_PREDS: {b}\nSEARCH_FACT: {c}\n"
         f"SEARCH_PREDS: {d}" for a, b, c, d in zip(
             s("fact"), s("preds"), s("fact_search"), s("preds_search"))],
        object)
    if "MapDate" in merged:
        merged[date_col] = _yyyymmdd(merged["MapDate"])
    elif "start_date" in merged:
        merged[date_col] = merged["start_date"]
    return take(merged, sort_order(merged[date_col]))


# ------------------------------------------------------------- TF-IDF


def _analyze(doc: str, ngram_range: Tuple[int, int]) -> list:
    """sklearn's word analyzer: lower case, the token pattern, n-grams."""
    tokens = _TOKEN.findall(doc.lower())
    min_n, max_n = ngram_range
    if max_n == 1:
        return tokens
    original = tokens
    if min_n == 1:
        tokens = list(original)
        min_n += 1
    else:
        tokens = []
    for n in range(min_n, min(max_n + 1, len(original) + 1)):
        for i in range(len(original) - n + 1):
            tokens.append(" ".join(original[i:i + n]))
    return tokens


def _counts(texts: Sequence[str], vocabulary: dict, ngram_range,
            grow: bool):
    """The (docs, terms) count matrix, CSR with sorted indices; with
    ``grow`` new terms enter ``vocabulary`` in order of appearance."""
    indices, values, indptr = [], [], [0]
    for doc in texts:
        counter: Dict[int, int] = {}
        for term in _analyze(doc, ngram_range):
            j = vocabulary.get(term)
            if j is None:
                if not grow:
                    continue
                j = vocabulary[term] = len(vocabulary)
            counter[j] = counter.get(j, 0) + 1
        indices.extend(counter)
        values.extend(counter.values())
        indptr.append(len(indices))
    X = scipy.sparse.csr_array(
        (np.asarray(values, np.float64), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int32)),
        shape=(len(texts), len(vocabulary)))
    X.sort_indices()
    return X


class Tfidf(NamedTuple):
    """A fitted TF-IDF: term -> column, and the idf of each column."""

    vocabulary: dict
    idf: np.ndarray
    ngram_range: Tuple[int, int]

    def transform(self, texts: Sequence[str]):
        """Rows of idf-weighted counts, each scaled to unit l2 norm (the
        sum of squares taken in index order, as sklearn's)."""
        X = _counts(texts, self.vocabulary, self.ngram_range, grow=False)
        X.data *= self.idf[X.indices]
        for i in range(X.shape[0]):
            row = X.data[X.indptr[i]:X.indptr[i + 1]]
            sq = np.cumsum(row * row)
            if len(sq) and sq[-1] != 0.0:
                row /= np.sqrt(sq[-1])
        return X


def tfidf_fit(texts: Sequence[str], max_features=None, ngram_range=(1, 1),
              min_df=1, max_df=1.0) -> Tfidf:
    """Fit ``TfidfVectorizer(max_features, ngram_range, min_df, max_df)``
    of sklearn 1.9 on ``texts``."""
    vocabulary: dict = {}
    X = _counts(texts, vocabulary, ngram_range, grow=True)
    if not vocabulary:
        raise ValueError("empty vocabulary; perhaps the documents only "
                         "contain stop words")

    def sort_terms(X):
        terms = sorted(vocabulary)
        where = np.empty(len(terms), np.int64)
        for new, term in enumerate(terms):
            where[vocabulary[term]] = new
            vocabulary[term] = new
        X.indices = where.take(X.indices).astype(X.indices.dtype)
        X.sort_indices()
        return X

    n_doc = X.shape[0]
    high = max_df if isinstance(max_df, int) else max_df * n_doc
    low = min_df if isinstance(min_df, int) else min_df * n_doc
    if high < low:
        raise ValueError("max_df corresponds to < documents than min_df")
    if max_features is not None:
        X = sort_terms(X)
    dfs = np.bincount(X.indices, minlength=X.shape[1])
    mask = (dfs <= high) & (dfs >= low)
    if max_features is not None and mask.sum() > max_features:
        tfs = np.asarray(X.sum(axis=0)).ravel()
        keep = (-tfs[mask]).argsort()[:max_features]
        new_mask = np.zeros(len(dfs), bool)
        new_mask[np.where(mask)[0][keep]] = True
        mask = new_mask
    new_index = np.cumsum(mask) - 1
    for term, old in list(vocabulary.items()):
        if mask[old]:
            vocabulary[term] = int(new_index[old])
        else:
            del vocabulary[term]
    kept = np.where(mask)[0]
    if len(kept) == 0:
        raise ValueError("After pruning, no terms remain. Try a lower "
                         "min_df or a higher max_df.")
    X = X[:, kept]
    if max_features is None:
        X = sort_terms(scipy.sparse.csr_array(X))
    df = np.bincount(scipy.sparse.csr_array(X).indices,
                     minlength=X.shape[1]).astype(np.float64) + 1.0
    idf = np.full_like(df, n_doc + 1)
    idf /= df
    np.log(idf, out=idf)
    idf += 1.0
    return Tfidf(vocabulary, idf, tuple(ngram_range))


# ------------------------------------------------------- truncated SVD


def svd_fit(X, n_components: int, seed: int = 0, n_iter: int = 5,
            n_oversamples: int = 10) -> np.ndarray:
    """The (n_components, terms) basis of sklearn 1.9's
    ``TruncatedSVD(n_components, random_state=seed).fit(X)``, its
    ``components_``."""
    n_samples, n_features = X.shape
    if n_features < 2:
        raise ValueError(f"TruncatedSVD needs at least 2 features, got "
                         f"{n_features}")
    if n_components > n_features:
        raise ValueError(f"n_components({n_components}) must be <= "
                         f"n_features({n_features}).")
    rs = np.random.RandomState(seed)
    transpose = n_samples < n_features
    M = X.T if transpose else X
    Q = rs.normal(size=(M.shape[1], n_components + n_oversamples))

    def lu(A):
        return scipy.linalg.lu(A, permute_l=True, check_finite=False)[0]

    for _ in range(n_iter):          # LU-normalised power iterations
        Q = lu(M @ Q) if n_iter > 2 else M @ Q
        Q = lu(M.T @ Q) if n_iter > 2 else M.T @ Q
    Q = scipy.linalg.qr(M @ Q, mode="economic", check_finite=False)[0]
    Uhat, _, Vt = scipy.linalg.svd(Q.T @ M, full_matrices=False,
                                   lapack_driver="gesdd")
    VT = (Q @ Uhat)[:, :n_components].T if transpose else \
        Vt[:n_components]
    # svd_flip(u_based_decision=False): each row's largest entry positive
    big = np.argmax(np.abs(VT), axis=1)
    return VT * np.sign(VT[np.arange(len(VT)), big])[:, None]


def embed_text(texts: Sequence[str], train_end: int,
               max_features: int = 20000, ngram_range=(1, 2),
               min_df: int = 2, embed_dim: int = 7, seed: int = 0):
    """Train-only TF-IDF + truncated SVD text embedding: returns
    ((N, embed_dim) float32, the fitted ``Tfidf``, the SVD basis)."""
    texts = ["" if t is None else str(t) for t in texts]
    vec = tfidf_fit(texts[:train_end], max_features=max_features,
                    ngram_range=ngram_range, min_df=min_df)
    tfidf_train = vec.transform(texts[:train_end])
    n_feat = tfidf_train.shape[1]
    n_comp = min(embed_dim, n_feat - 1) if n_feat > 1 else 1
    basis = svd_fit(tfidf_train, max(n_comp, 1), seed=seed)
    emb = (vec.transform(texts) @ basis.T).astype(np.float32)
    if emb.shape[1] < embed_dim:       # pad if the vocabulary was tiny
        emb = np.pad(emb, ((0, 0), (0, embed_dim - emb.shape[1])))
    return emb, vec, basis


def fuse_features(X_num: np.ndarray, texts: Sequence[str], train_end: int,
                  embed_dim: int = 7, **embed_kw):
    """Numeric + text-embedding feature matrix (N, F_num + embed_dim)."""
    emb, vec, basis = embed_text(texts, train_end, embed_dim=embed_dim,
                                 **embed_kw)
    X = np.concatenate([X_num.astype(np.float32), emb], axis=1)
    return X, {"vectorizer": vec, "svd": basis}


def assert_feature_dim(model_in_dim: int, X: np.ndarray):
    """The model's input width must equal the fused feature width."""
    if X.shape[1] != model_in_dim:
        raise ValueError(
            f"model expects {model_in_dim} features but data has {X.shape[1]}"
            " — rebuild the model after text fusion changes the feature dim")
