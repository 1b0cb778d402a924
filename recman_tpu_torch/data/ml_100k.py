"""MovieLens-100K pipeline — the parity dataset, in numpy only.

Counterpart of ``recman_tpu/data/ml_100k.py``, which is built on pandas
(``read_csv``, ``merge``, ``DataFrame.sample``). This module parses the
same files as latin-1 text and returns tables as dicts of numpy column
arrays (ints as int64, text as object arrays of str, the label as
float64), holding exactly the reference's rows in the reference's order:

- ``get_data``: the interactions of ``u{set}.base`` / ``u{set}.test``
  inner-joined with ``u.user`` on user_id, then with u.item's item_id,
  title, release_date and the pipe-joined genres on item_id. Both joins
  keep the interactions' row order, as pandas' inner merge does.
- ``get_ml_dataset``: ``DataFrame.sample(frac, random_state=seed)`` is
  ``RandomState(seed).choice(n, round(frac * n), replace=False)``; the
  valid split is the sampled rows outside the train sample, in sample
  order (``df_all.drop(df_train.index)``).
- ``create_ml_features``: the reference's schema over a column dict
  (``FeatureSet`` reads ``X[name]``).
- ``add_history_feature``: each row's previously rated items, built over
  the union of the tables in the reference's stable order (user,
  timestamp, table, row label). ``get_ml_dataset(return_index=True)``
  gives the row labels, which are the pandas frames' index: they order
  the rows of one table that tie on user and timestamp.
- ``create_ml_sequence_features``: the schema and the history
  ``SequenceFeat`` tied to item_id's table, which DIN, BST and DIEN take.
"""

from __future__ import annotations

import os

import numpy as np

from ..features import DenseFeat, FeatureSet, MultiValCsvFeat, SequenceFeat, SparseFeat

DEFAULT_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def _read_rows(path, delimiter):
    """Non-blank lines of a latin-1 text file, split on ``delimiter``."""
    with open(path, encoding="latin-1") as f:
        return [line.rstrip("\r\n").split(delimiter) for line in f if line.strip()]


def _text_column(values):
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _join_positions(keys, table_keys):
    """Row of ``table_keys`` for each key (-1 where absent); table keys
    are unique."""
    where = {k: i for i, k in enumerate(table_keys.tolist())}
    return np.fromiter((where.get(k, -1) for k in keys.tolist()), dtype=np.int64,
                       count=len(keys))


def get_data(data_dir=DEFAULT_DATA_DIR, file_set="a"):
    """Load and join the ML-100K tables (reference ml_100k.py:28-76).

    Returns (train_all, test_all, domains): two column dicts and the
    genre/occupation vocabularies."""
    root = os.path.join(data_dir, "ml-100k")
    genre_names = list(dict.fromkeys(r[0] for r in _read_rows(f"{root}/u.genre", "|")))
    occupations = [r[0] for r in _read_rows(f"{root}/u.occupation", "|")]

    users = _read_rows(f"{root}/u.user", "|")
    user_cols = {
        "user_id": np.array([int(r[0]) for r in users], dtype=np.int64),
        "age": np.array([int(r[1]) for r in users], dtype=np.int64),
        "gender": _text_column([r[2] for r in users]),
        "occupation": _text_column([r[3] for r in users]),
        "zip": _text_column([r[4] for r in users]),
    }
    items = _read_rows(f"{root}/u.item", "|")
    item_cols = {
        "item_id": np.array([int(r[0]) for r in items], dtype=np.int64),
        "title": _text_column([r[1] for r in items]),
        "release_date": _text_column([r[2] for r in items]),
        # pipe-joined genre string per movie (reference ml_100k.py:53-58)
        "genres": _text_column([
            "|".join(g for g, on in zip(genre_names, r[5:]) if int(on) == 1) for r in items
        ]),
    }

    def load_interactions(path):
        rows = np.array(_read_rows(path, "\t"), dtype=np.int64)
        cols = dict(zip(("user_id", "item_id", "rating", "timestamp"), rows.T))
        u = _join_positions(cols["user_id"], user_cols["user_id"])
        i = _join_positions(cols["item_id"], item_cols["item_id"])
        keep = (u >= 0) & (i >= 0)
        out = {k: np.ascontiguousarray(v[keep]) for k, v in cols.items()}
        out.update({k: v[u[keep]] for k, v in user_cols.items() if k != "user_id"})
        out.update({k: v[i[keep]] for k, v in item_cols.items() if k != "item_id"})
        return out

    train_all = load_interactions(f"{root}/u{file_set}.base")
    test_all = load_interactions(f"{root}/u{file_set}.test")
    domains = dict(genres=genre_names, occupations=occupations)
    return train_all, test_all, domains


def take_rows(table: dict, rows) -> dict:
    """Rows ``rows`` (positions or a boolean mask) of every column."""
    return {k: v[rows] for k, v in table.items()}


def concat_rows(*tables) -> dict:
    """The tables' rows one after another (``pd.concat``)."""
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def _sample_positions(n, frac, random_state):
    """``DataFrame.sample(frac=frac, random_state=random_state)``'s rows."""
    return np.random.RandomState(random_state).choice(n, round(frac * n), replace=False)


def get_ml_dataset(frac=0.5, random_seed=2019, data_dir=DEFAULT_DATA_DIR, return_index=False):
    """Binarize + subsample + 70/30 split (reference ml_100k.py:79-89).
    Returns (train, valid, test, domains), column dicts with a float64
    ``label`` (rating >= 4). ``return_index`` appends the three tables'
    row labels, the reference frames' index (a row's position in its
    joined table), which ``add_history_feature`` takes."""
    all_rows, test, domains = get_data(data_dir)
    sampled = _sample_positions(len(all_rows["rating"]), frac, random_seed)
    all_rows = take_rows(all_rows, sampled)
    for t in (all_rows, test):
        t["label"] = (t["rating"] >= 4).astype(np.float64)
    m = len(all_rows["rating"])
    in_train = _sample_positions(m, 0.7, random_seed)
    valid = np.ones(m, dtype=bool)
    valid[in_train] = False
    out = (take_rows(all_rows, in_train), take_rows(all_rows, valid), test, domains)
    if return_index:
        out += ((sampled[in_train], sampled[valid], np.arange(len(test["rating"]))),)
    return out


def create_ml_features(df_data, domains) -> FeatureSet:
    """The canonical ML-100K schema (reference examples/utils.py:29-75):
    5 SparseFeat + 2 MinMax DenseFeat + 1 MultiValCsvFeat."""
    fs = FeatureSet()
    for name in ("user_id", "item_id", "gender", "occupation", "zip"):
        fs[name] = SparseFeat(name, feat_size=len(np.unique(df_data[name])))
    fs["timestamp"] = DenseFeat("timestamp", scaler="minmax")
    fs["age"] = DenseFeat("age", scaler="minmax")
    fs["genres"] = MultiValCsvFeat("genres", tags=tuple(domains["genres"]))
    fs.initialize(df_data)
    return fs


def add_history_feature(*tables, max_len=10, index=None):
    """Copies of the column dicts ``tables``, each with a ``hist_items``
    column: per row, an int64 array of the item_ids its user rated
    strictly before it, most recent last, the last ``max_len`` of them
    (reference ml_100k.py:105-146).

    The history is built over the union of the tables, ordered stably by
    (user_id, timestamp, table, row label): rows that tie on user and
    timestamp follow table order, then row label. ``index``: per table,
    its row labels (``get_ml_dataset(return_index=True)``); default each
    table's positions. Labels are never read."""
    if index is None:
        index = [np.arange(len(t["user_id"])) for t in tables]
    sizes = [len(t["user_id"]) for t in tables]
    user = np.concatenate([np.asarray(t["user_id"]) for t in tables])
    stamp = np.concatenate([np.asarray(t["timestamp"]) for t in tables])
    items = np.concatenate([np.asarray(t["item_id"]) for t in tables]).astype(np.int64)
    src = np.repeat(np.arange(len(tables)), sizes)
    label = np.concatenate([np.asarray(i) for i in index])
    order = np.lexsort((label, src, stamp, user))  # last key first

    hist = np.empty(len(order), dtype=object)
    sorted_user, sorted_items = user[order], items[order]
    start = 0  # first sorted position of the current user
    for pos, row in enumerate(order.tolist()):
        if sorted_user[pos] != sorted_user[start]:
            start = pos
        hist[row] = sorted_items[max(start, pos - max_len):pos]

    out, offset = [], 0
    for t, n in zip(tables, sizes):
        t = dict(t)
        t["hist_items"] = hist[offset:offset + n]
        out.append(t)
        offset += n
    return out[0] if len(out) == 1 else tuple(out)


def create_ml_sequence_features(df_data, domains, max_len=10) -> FeatureSet:
    """The canonical schema + a SequenceFeat over ``hist_items`` tied to
    item_id's table (reference ml_100k.py:149-157): the schema DIN, BST
    and DIEN train on for the ML-100K rows."""
    fs = create_ml_features(df_data, domains)
    fs["hist_items"] = SequenceFeat("hist_items", id_feat=fs["item_id"], max_len=max_len)
    return fs
