"""The port's ``sql`` (a host-only copy of ``tpudl/frame/sql.py`` over the
port's ``Frame``) held to tpudl's: the same numpy columns go into both
packages' frames, the same query runs through both, and the outputs must
be equal (columns, order, NULLs and NaNs), or both must raise the same
exception type. UDF calls go through each package's own registry with a
host UDF that counts the rows it is given, so LIMIT pushdown and WHERE
before the UDF are held too. Exact equality: both run the same numpy
code on the same inputs."""

import numpy as np
import pytest

from tpudl.frame import Frame as JaxFrame
from tpudl.frame import sql as jax_sql
from tpudl.udf import registry as jax_registry
from tpudl_torch.frame import Frame, sql
from tpudl_torch.udf import registry


def _columns():
    rng = np.random.default_rng(0)
    cls = np.array(["cat", "dog", "cat", "dog", "cat", None, "eel", None],
                   dtype=object)
    score = np.array([1.0, 2.0, 3.0, np.nan, 5.0, 7.0, np.inf, -np.inf])
    mixed = np.array(["a", 7, None, 3, 2.5, "b", None, 1], dtype=object)
    return {
        "t": {"cls": cls, "score": score,
              "n": np.arange(8, dtype=np.int64),
              "x": rng.normal(size=8).astype(np.float32),
              "mixed": mixed,
              "word": np.array(["pear", "apple", "fig", "kiwi", "date",
                                "plum", "lime", "yam"])},
        "big": {"x": np.arange(100.0), "k": np.arange(100) % 3},
        "quote": {"name": np.array(["salt and pepper", "a order by b",
                                    "limit 3", "sugar", "x where y"],
                                   dtype=object),
                  "v": np.arange(5.0)},
    }


QUERIES = [
    # projections
    "SELECT * FROM t",
    "SELECT cls, score FROM t",
    "SELECT score AS s, n FROM t",
    "select word from t limit 3;",
    "SELECT * FROM t WHERE score = 2 LIMIT 5",
    # WHERE, NULL semantics
    "SELECT n FROM t WHERE score > 1.5",
    "SELECT n FROM t WHERE score != 2",
    "SELECT n FROM t WHERE score <> 2 AND n >= 3",
    "SELECT cls FROM t WHERE cls = 'cat'",
    "SELECT n FROM t WHERE cls != 'cat'",
    "SELECT n FROM t WHERE cls IS NULL",
    "SELECT n FROM t WHERE score IS NOT NULL AND cls IS NOT NULL",
    "SELECT mixed FROM t WHERE mixed < 5",
    "SELECT n FROM t WHERE n <= -1",
    # every aggregate, with and without GROUP BY
    "SELECT COUNT(*) AS c, COUNT(score) AS k, SUM(score) AS s, "
    "AVG(score) AS a, MIN(score) AS lo, MAX(score) AS hi FROM t",
    "SELECT COUNT(*), SUM(n), MEAN(x), MIN(x), MAX(x) FROM t",
    "SELECT SUM(score) AS s FROM t WHERE n > 100",
    "SELECT cls, COUNT(*) AS c, SUM(score) AS s FROM t GROUP BY cls",
    "SELECT cls, AVG(x) AS a, MIN(n) AS lo, MAX(n) AS hi FROM t "
    "GROUP BY cls ORDER BY cls DESC",
    "SELECT cls, COUNT(*) AS c FROM t GROUP BY cls ORDER BY c DESC, cls",
    "SELECT k, COUNT(x) AS c, SUM(x) AS s FROM big GROUP BY k ORDER BY k",
    "SELECT cls, AVG(score) AS a FROM t WHERE score > 1 GROUP BY cls "
    "ORDER BY a DESC LIMIT 1",
    "SELECT MIN(word) AS lo, MAX(word) AS hi FROM t",
    # ORDER BY, NULLs last both ways, infinities, strings
    "SELECT score FROM t ORDER BY score",
    "SELECT score FROM t ORDER BY score DESC",
    "SELECT cls, score FROM t WHERE cls IS NOT NULL "
    "ORDER BY cls DESC, score DESC LIMIT 3",
    "SELECT cls, n FROM t ORDER BY cls",
    "SELECT word FROM t ORDER BY word DESC",
    "SELECT x, n FROM t ORDER BY x LIMIT 4",
    # quoted keywords inside WHERE literals
    "SELECT v FROM quote WHERE name = 'salt and pepper'",
    "SELECT v FROM quote WHERE name = 'a order by b'",
    "SELECT v FROM quote WHERE name = 'limit 3'",
    "SELECT name FROM quote WHERE name != 'x where y' AND v < 4 "
    "ORDER BY name",
    # UDFs: WHERE before the UDF, LIMIT pushdown, ORDER BY forces it all
    "SELECT count2(x) AS y FROM big WHERE x < 3",
    "SELECT count2(x) AS y FROM big LIMIT 3",
    "SELECT x, count2(x) AS y FROM big ORDER BY x DESC LIMIT 3",
    "SELECT count2(score) FROM t WHERE score IS NOT NULL",
    # malformed or refused queries: the same exception type
    "SELECT x FROM nowhere",
    "SELECT nosuch FROM t",
    "SELECT n FROM t WHERE nosuch = 1",
    "SELECT n FROM t WHERE score BETWEEN 1 AND 2",
    "SELECT n FROM t WHERE score = 'two'",
    "SELECT score, COUNT(*) FROM t",
    "SELECT score, COUNT(*) FROM t GROUP BY cls",
    "SELECT *, COUNT(*) FROM t GROUP BY cls",
    "SELECT count2(score) FROM t GROUP BY cls",
    "SELECT SUM(*) FROM t",
    "SELECT SUM(cls) FROM t GROUP BY cls",
    "SELECT COUNT(DISTINCT cls) FROM t",
    "SELECT n, n FROM t",
    "SELECT n FROM t ORDER BY n SIDEWAYS",
    "SELECT n + 1 FROM t",
    "DELETE FROM t",
    "SELECT nope(x) FROM big",
]


@pytest.fixture(scope="module")
def counted():
    """A host UDF ``count2`` in each package's registry: doubles its
    column and records how many rows each call got."""
    calls = {"jax": [], "torch": []}

    def make(which):
        def fn(frame):
            calls[which].append(len(frame))
            return frame.with_column("y", np.asarray(frame["x"]) * 2)
        return fn

    jax_registry.register_udf("count2", make("jax"), "x", "y")
    registry.register_udf("count2", make("torch"), "x", "y")
    yield calls
    jax_registry.unregister_udf("count2")
    registry.unregister_udf("count2")


def _same_column(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        for u, v in zip(a, b):
            if isinstance(u, float) and isinstance(v, float) and \
                    np.isnan(u) and np.isnan(v):
                continue
            assert type(u) is type(v) and u == v, (u, v)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_tpudl(query, counted):
    cols = _columns()
    theirs_tables = {k: JaxFrame(v) for k, v in cols.items()}
    ours_tables = {k: Frame(v) for k, v in cols.items()}
    for calls in counted.values():
        calls.clear()
    try:
        want = jax_sql(query, theirs_tables)
    except Exception as e:  # the port must raise the same type
        with pytest.raises(type(e)):
            sql(query, ours_tables)
        return
    got = sql(query, ours_tables)
    assert got.columns == want.columns and len(got) == len(want)
    for c in want.columns:
        _same_column(got[c], want[c])
    assert counted["torch"] == counted["jax"]
    if "count2" in query and "LIMIT 3" in query and "ORDER" not in query:
        assert counted["torch"] == [3]      # rows past LIMIT never ran


def test_registry_is_the_ports_own():
    registry.register_udf("only_here", lambda f: f, "x", "y")
    try:
        assert "only_here" in registry.list_udfs()
        assert "only_here" not in jax_registry.list_udfs()
        with pytest.raises(KeyError, match="no UDF registered"):
            jax_registry.get_udf("only_here")
    finally:
        registry.unregister_udf("only_here")
    with pytest.raises(KeyError, match="no UDF registered"):
        registry.get_udf("only_here")
