"""Json attributes and ``jsonPath()`` predicates of the port against the JAX
package's: the cases of ``tests/test_json_attr.py`` (all but the Arrow half,
whose output path the port does not serve), each answer equal to the JAX
package's and to the reference test's number; the ``ValueError`` on a
non-Json attribute, the temporal-on-jsonPath raise and the parse errors;
an indexed Json attribute; ``update_schema`` adding a Json column; a
``bbox AND jsonPath()`` query against a NumPy oracle; ``json_path_get``
against the reference's ``_json_path_get``; and roots carried across (a
root the JAX package saved with a Json column loads in the port, and a
port root in the JAX package)."""

import json

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu.convert.converter import _json_path_get
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.convert import json_path_get
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms

SPEC = "props:Json,dtg:Date,*geom:Point"
DOCS = [
    '{"type": "car", "speed": 42, "tags": ["a", "b"]}',
    '{"type": "truck", "speed": 80, "extra": {"axles": 3}}',
    '{"type": "car", "speed": 12}',
    '{"speed": 99}',
    None,
    'not valid json',
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _insert(ds, name, docs, x=None):
    n = len(docs)
    ds.insert(name, {
        "props": docs,
        "dtg": np.full(n, parse_iso_ms("2022-01-01")).astype("datetime64[ms]"),
        "geom__x": np.linspace(-10, 10, n) if x is None else x,
        "geom__y": np.zeros(n),
    }, fids=np.arange(n).astype(str))
    ds.flush(name)


@pytest.fixture(scope="module")
def pair():
    out = []
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("j", SPEC)
        _insert(ds, "j", DOCS)
        out.append(ds)
    return tuple(out)


#: the reference test's queries and answers (tests/test_json_attr.py)
CASES = {
    "eq_car": ("jsonPath('$.type', props) = 'car'", 2),
    "eq_truck": ("jsonPath('$.type', props) = 'truck'", 1),
    "gt": ("jsonPath('$.speed', props) > 40", 3),
    "le": ("jsonPath('$.speed', props) <= 42", 2),
    "between": ("jsonPath('$.speed', props) BETWEEN 40 AND 90", 2),
    "nested": ("jsonPath('$.extra.axles', props) = 3", 1),
    "is_null": ("jsonPath('$.type', props) IS NULL", 3),
    "is_not_null": ("jsonPath('$.type', props) IS NOT NULL", 3),
    "like": ("jsonPath('$.type', props) LIKE 'c%'", 2),
    "in": ("jsonPath('$.type', props) IN ('car', 'truck')", 3),
    "and": ("jsonPath('$.type', props) = 'car' AND jsonPath('$.speed', props) > 20", 1),
    "not": ("NOT (jsonPath('$.type', props) = 'car')", 4),
    "wildcard": ("jsonPath('$.tags[*]', props) = 'b'", 1),
    "index": ("jsonPath('$.tags[0]', props) = 'a'", 1),
    "quoted_key": ("jsonPath('$[''type'']', props) = 'car'", None),
    "ne": ("jsonPath('$.type', props) <> 'car'", None),
    "with_bbox": ("BBOX(geom, -5, -5, 5, 5) AND jsonPath('$.type', props) = 'car'", None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_jsonpath_counts_equal(pair, name):
    j, p = pair
    q, want = CASES[name]
    jplan = j._plan("j", q)[2]
    got = p.count("j", q)
    assert got == j.count("j", q)
    if want is not None:
        assert got == want
    assert repr(parse_ecql(q)) == repr(jparse(q))
    # a host predicate: both packages scan on the host
    assert p._plan("j", q).exec_path["scan"] == jplan.exec_path["scan"] == "host"


def test_json_roundtrip_query(pair):
    j, p = pair
    q = "jsonPath('$.type', props) = 'truck'"
    fp, fj = p.query("j", q), j.query("j", q)
    assert len(fp) == len(fj) == 1
    assert list(fp.columns["props"]) == list(fj.columns["props"])
    assert '"axles": 3' in fp.columns["props"][0]
    everything = p.query("j")
    assert sum(v is None for v in everything.columns["props"]) == 1
    assert list(everything.columns["props"]) == list(j.query("j").columns["props"])


def test_jsonpath_on_non_json_attr_raises(pair):
    for ds in pair:
        with pytest.raises(ValueError, match="requires a Json attribute"):
            ds.count("j", "jsonPath('$.a', dtg) = 1")


def test_temporal_on_jsonpath_raises(pair):
    for ds in pair:
        with pytest.raises(ValueError, match="not supported on jsonPath"):
            ds.count("j", "jsonPath('$.t', props) AFTER 2022-01-01T00:00:00Z")


@pytest.mark.parametrize("q", [
    "jsonPath('$.a', props) + 1 > 2",
    "st_area(jsonPath('$.a', props)) > 2",
    "jsonPath('$.a', props) = jsonPath('$.b', props)",
    "props + 1 > 2",
], ids=["arith", "fn_arg", "json_json", "bare_json_expr"])
def test_jsonpath_misuse_raises(pair, q):
    for ds in pair:
        with pytest.raises(ValueError):
            ds.count("j", q)


def test_indexed_json_attr_ingests():
    """``index=true`` on a Json attribute builds no attribute index and no
    sketch over document text, as the reference's."""
    out = []
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("ji", "props:Json:index=true,dtg:Date,*geom:Point")
        _insert(ds, "ji", ['{"a": 1}', None], x=np.array([0.0, 1.0]))
        assert ds.count("ji") == 2
        assert ds.count("ji", "jsonPath('$.a', props) = 1") == 1
        st = ds._store("ji")
        out.append((sorted(st.tables), sorted(st.stats)))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="cannot attribute-index"):
        ds._store("ji").add_attribute_index("props")


def test_update_schema_adds_json():
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("u", "dtg:Date,*geom:Point")
        ds.insert("u", {
            "dtg": np.full(2, parse_iso_ms("2022-01-01")).astype("datetime64[ms]"),
            "geom__x": [0.0, 1.0], "geom__y": [0.0, 1.0],
        }, fids=["a", "b"])
        ds.flush("u")
        ds.update_schema("u", "props:Json")
        assert ds.count("u", "jsonPath('$.a', props) IS NULL") == 2
        ds.insert("u", {
            "props": [{"a": 7}],
            "dtg": np.full(1, parse_iso_ms("2022-01-02")).astype("datetime64[ms]"),
            "geom__x": [2.0], "geom__y": [2.0],
        }, fids=["c"])
        ds.flush("u")
        assert ds.count("u", "jsonPath('$.a', props) = 7") == 1
        assert ds.get_schema("u").spec() == "dtg:Date,*geom:Point,props:Json"


def test_bbox_and_jsonpath_against_an_oracle():
    """A few thousand seeded documents: ``bbox AND jsonPath('$.type') =
    'car'`` and a numeric range, against a NumPy oracle."""
    rng = np.random.default_rng(4)
    n = 3000
    kinds = np.array(["car", "truck", "bike"])[rng.integers(0, 3, n)]
    speed = rng.integers(0, 120, n)
    docs = [json.dumps({"type": str(k), "speed": int(s)}) for k, s in zip(kinds, speed)]
    docs[::97] = [None] * len(docs[::97])
    x, y = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    inbox = (x >= -5) & (x <= 5) & (y >= -5) & (y <= 5)
    present = np.array([d is not None for d in docs])
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("o", SPEC)
        ds.insert("o", {
            "props": docs,
            "dtg": np.full(n, parse_iso_ms("2022-01-01")).astype("datetime64[ms]"),
            "geom__x": x, "geom__y": y,
        }, fids=np.arange(n).astype(str))
        ds.flush("o")
        q = "BBOX(geom, -5, -5, 5, 5) AND jsonPath('$.type', props) = 'car'"
        assert ds.count("o", q) == int((inbox & present & (kinds == "car")).sum())
        q = "BBOX(geom, -5, -5, 5, 5) AND jsonPath('$.speed', props) BETWEEN 30 AND 60"
        assert ds.count("o", q) == int((inbox & present & (speed >= 30) & (speed <= 60)).sum())


@pytest.mark.parametrize("path", [
    "$.a.b", "a.b", "$['a']", "$.c[0]", "$.c[*]", "$.c[*].d", "$.c[5]", "$.missing",
    "$.c[1].d",
])
def test_json_path_get_equals_the_reference(path):
    doc = {"a": {"b": 1}, "c": [{"d": 2}, {"d": [3, 4]}, 5]}
    assert json_path_get(doc, path) == _json_path_get(doc, path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_roots_with_a_json_column_interchange(pair, writer, tmp_path):
    """Either package's root loads in both, with equal answers. A null
    document comes back as the text ``'None'`` in both packages (the
    reference's checkpoint stores the column as text), which parses as no
    document: every count is unchanged."""
    j, p = pair
    root = str(tmp_path / "root")
    (j if writer == "jax" else p).save(root)
    lp, lj = GeoDataset.load(root, device="cpu"), JGeoDataset.load(root)
    assert lp.get_schema("j").spec() == lj.get_schema("j").spec() == j.get_schema("j").spec()
    for q, _ in CASES.values():
        assert lp.count("j", q) == lj.count("j", q) == j.count("j", q), q
    assert list(lp.query("j").columns["props"]) == list(lj.query("j").columns["props"])
