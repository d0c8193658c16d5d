"""MQ2007 learning-to-rank reader (ref: python/paddle/dataset/mq2007.py).
Same three access formats — pointwise (feature, score), pairwise
(d_high, d_low), listwise (label_list, feature_list) — over a synthetic
deterministic query/document pool with the real 46-dim feature schema
(zero egress). Local LETOR-format files can be parsed via
load_from_text()."""
import numpy as np

__all__ = ["train", "test"]

FEATURE_DIM = 46


class Query:
    def __init__(self, query_id, relevance_score, feature_vector):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = list(feature_vector)


class QueryList:
    def __init__(self, querylist=None):
        self.querylist = querylist or []

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def add(self, q):
        self.querylist.append(q)


def _synth_querylists(split):
    rng = np.random.default_rng({"train": 71, "test": 72}[split])
    n_queries = {"train": 120, "test": 40}[split]
    for qid in range(n_queries):
        ql = QueryList()
        w = rng.normal(size=FEATURE_DIM)
        for _ in range(int(rng.integers(4, 12))):
            feat = rng.normal(size=FEATURE_DIM)
            # relevance correlates with a per-query direction (learnable)
            rel = int(np.clip(round(float(feat @ w) / 8 + 1), 0, 2))
            ql.add(Query(qid, rel, feat.astype("float32")))
        yield ql


def load_from_text(filepath, shuffle=False, fill_missing=-1):
    """Parse a LETOR-format file: '<rel> qid:<id> 1:<v> 2:<v> ...'."""
    lists = {}
    with open(filepath) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            rel = int(parts[0])
            qid = int(parts[1].split(":")[1])
            feat = [fill_missing] * FEATURE_DIM
            for tok in parts[2:]:
                if ":" not in tok or tok.startswith("#"):
                    break
                k, v = tok.split(":")
                idx = int(k) - 1
                if 0 <= idx < FEATURE_DIM:
                    feat[idx] = float(v)
            lists.setdefault(qid, QueryList()).add(Query(qid, rel, feat))
    out = list(lists.values())
    if shuffle:
        import random
        random.shuffle(out)
    return out


def gen_point(querylist):
    for q in querylist:
        yield q.relevance_score, np.asarray(q.feature_vector, "float32")


def gen_pair(querylist, partial_order="full"):
    if partial_order != "full":
        raise NotImplementedError(
            "mq2007.gen_pair: only partial_order='full' is supported "
            "(every (higher, lower) relevance pair)"
        )
    qs = sorted(querylist, key=lambda q: -q.relevance_score)
    for i, hi in enumerate(qs):
        for lo in qs[i + 1:]:
            if hi.relevance_score > lo.relevance_score:
                yield (
                    np.array([1.0], "float32"),
                    np.asarray(hi.feature_vector, "float32"),
                    np.asarray(lo.feature_vector, "float32"),
                )


def gen_list(querylist):
    labels = [q.relevance_score for q in querylist]
    feats = [np.asarray(q.feature_vector, "float32") for q in querylist]
    yield labels, feats


_FORMATS = {
    "pointwise": gen_point,
    "pairwise": gen_pair,
    "listwise": gen_list,
}


def _creator(split, fmt):
    if fmt not in _FORMATS:
        raise ValueError(
            "mq2007 format must be one of %s" % sorted(_FORMATS)
        )

    def reader():
        for ql in _synth_querylists(split):
            yield from _FORMATS[fmt](ql)

    return reader


def train(format="pairwise"):
    return _creator("train", format)


def test(format="pairwise"):
    return _creator("test", format)


def fetch():
    """No-op (zero-egress): data is synthesized on the fly."""
