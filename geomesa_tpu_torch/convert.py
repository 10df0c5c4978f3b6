"""Carry an indexed store across from NumPy arrays, and the JSON path
reader of stored documents.

A database's counterpart of loading weights: a store built elsewhere (for
example by the JAX package, read off its ``FeatureStore``) is rebuilt here
from its master columns, and each index table given with its sorted state
keeps that state without re-sorting, so both packages answer queries over
identical rows, order and shard layout. :func:`json_path_get` is a copy of
``_json_path_get`` in ``geomesa_tpu/convert/converter.py``, which the
``jsonPath()`` predicates read documents with.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from geomesa_tpu_torch.api.dataset import resolve_device
from geomesa_tpu_torch.index.store import FeatureStore, device_view
from geomesa_tpu_torch.schema.columns import ColumnBatch, DictionaryEncoder, encode_fids
from geomesa_tpu_torch.schema.feature_type import FeatureType


def store_from_arrays(spec: str, arrays: Dict, n_shards: int, device=None,
                      name: str = "t") -> FeatureStore:
    """Build a :class:`FeatureStore` from ``arrays``:

    * ``"master"``: master columns in ingest order (f64 coordinates, the
      int64 date and its int32 ``__bin``/``__off`` pair, attributes with
      strings as dictionary codes, and ``__fid__``; fids missing are
      generated);
    * ``"dicts"`` (optional): string attribute -> dictionary values, in
      code order;
    * ``"tables"`` (optional): index name -> ``{"order", "keys",
      "shard_bounds", "key_shifts"}``, a table's sorted state (its
      sorted-row -> master-row permutation, sorted (quantized) key columns,
      ``n_shards + 1`` row offsets and key shifts). Attribute tables, and
      every index table not given, are built here from the master columns;
    * ``"device"`` (optional): index name -> sorted f32 / int32 device views
      by column, checked against that table's master columns gathered
      through its ``order`` (the store always derives its device columns
      from the master).

    The write-time sketches observe every row.
    """
    ft = FeatureType.from_spec(name, spec)
    store = FeatureStore(ft, n_shards, resolve_device(device))
    master = {k: np.asarray(v) for k, v in arrays["master"].items()}
    n = len(next(iter(master.values())))
    if any(len(v) != n for v in master.values()):
        raise ValueError("master columns differ in length")
    if "__fid__" not in master:
        master["__fid__"] = encode_fids(None, n)
    for attr, values in arrays.get("dicts", {}).items():
        store.dicts[attr] = DictionaryEncoder(list(values))
    keys: Dict[str, np.ndarray] = {}
    for ks in store.keyspaces:
        keys.update(ks.index_keys(ft, master))
    stat_cols = {**master, **keys}
    if "__z3" in keys:
        stat_cols["__z3_period"] = ft.time_period
    for st in store.stats.values():
        st.observe(stat_cols)
    key_cols = {**master, **keys}
    given = arrays.get("tables", {})
    for tname, table in store.tables.items():
        state = given.get(tname)
        if state is not None and tname.startswith("attr:"):
            raise ValueError(f"table {tname!r}: attribute tables are built "
                             "from the master columns")
        if state is None:
            table.rebuild(key_cols, store.dicts)
            continue
        order = np.asarray(state["order"])
        if len(order) != n:
            raise ValueError(f"table {tname!r}: order and master columns differ in length")
        table.set_state(key_cols, order,
                        {k: np.asarray(state["keys"][k]) for k in table.keyspace.key_cols},
                        state.get("key_shifts"), state["shard_bounds"])
    for tname, views in arrays.get("device", {}).items():
        order = store.tables[tname].order
        for k, v in views.items():
            want = device_view(master[k][order])
            if want is None or not np.array_equal(np.asarray(v), want):
                raise ValueError(f"device column {k!r} of table {tname!r} "
                                 "disagrees with master[order]")
    store._all = ColumnBatch(master, n)
    store._key_cols = keys
    store.version += 1
    return store


def json_path_get(obj, path: str) -> List:
    """The values a path names in a parsed document, for a small JsonPath
    subset: ``$.a.b``, ``a.b``, ``$['a']``, array indices ``[0]`` and
    ``[*]``."""
    parts = re.findall(r"\[\*\]|\[(?:'([^']*)'|(\d+))\]|([A-Za-z0-9_\-]+)", path)
    cur = [obj]
    for quoted, idx, name in parts:
        nxt = []
        for c in cur:
            if c is None:
                continue
            if quoted or name:
                key = quoted or name
                if key == "$":
                    nxt.append(c)
                elif isinstance(c, dict):
                    nxt.append(c.get(key))
            elif idx:
                if isinstance(c, list) and int(idx) < len(c):
                    nxt.append(c[int(idx)])
            else:  # [*]
                if isinstance(c, list):
                    nxt.extend(c)
        cur = nxt
    return cur
