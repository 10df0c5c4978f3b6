"""Carry an indexed store across from NumPy arrays, without re-sorting.

A database's counterpart of loading weights: a store built elsewhere (for
example by the JAX package, read off its ``FeatureStore``) is rebuilt here
from its sorted state, so both packages answer queries over identical
rows, order and shard layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from geomesa_tpu_torch.api.dataset import resolve_device
from geomesa_tpu_torch.index.store import FeatureStore, device_view
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.schema.feature_type import FeatureType


def store_from_arrays(spec: str, arrays: Dict, n_shards: int, device=None,
                      name: str = "t") -> FeatureStore:
    """Build a :class:`FeatureStore` from ``arrays``:

    * ``"master"``: master columns in ingest order (f64 coordinates, the
      int64 date and its int32 ``__bin``/``__off`` pair, attributes);
    * ``"keys"``: the sorted (quantized) ``__z3_bin`` / ``__z3`` columns;
    * ``"order"``: the sorted-row -> master-row permutation;
    * ``"shard_bounds"``: ``n_shards + 1`` row offsets;
    * ``"key_shifts"``: key quantization shifts (None = raw keys);
    * ``"device"`` (optional): sorted f32 / int32 device views by column,
      checked against the master columns gathered through ``order`` (the
      store always derives its device columns from the master).
    """
    ft = FeatureType.from_spec(name, spec)
    store = FeatureStore(ft, n_shards, resolve_device(device))
    master = {k: np.asarray(v) for k, v in arrays["master"].items()}
    order = np.asarray(arrays["order"])
    n = len(order)
    if any(len(v) != n for v in master.values()):
        raise ValueError("master columns and order differ in length")
    keys = {k: np.asarray(arrays["keys"][k]) for k in store.keyspace.key_cols}
    for k, v in arrays.get("device", {}).items():
        want = device_view(master[k][order])
        if want is None or not np.array_equal(np.asarray(v), want):
            raise ValueError(f"device column {k!r} disagrees with master[order]")
    store.table.set_state(
        master, order, keys, arrays.get("key_shifts"),
        arrays["shard_bounds"],
    )
    store._all = ColumnBatch(master, n)
    store.version += 1
    return store
