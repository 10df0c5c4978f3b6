"""Aggregate-cache persistence through the lake container.

Copy of ``geomesa_tpu/lake/persist.py``. The warm cell, hierarchy,
curve-chunk and whole-result entries of a dataset's ``CacheStore`` are
written through the footer-indexed container the partition snapshots use
(``lake/format.py``), so a restarted process re-serves warm aggregates
without a rescan: a fully warm zoom-out answers with no device launch
right after :func:`restore_cache`. The files interchange with the JAX
package's.

A persisted entry is only valid against the data it was computed from.
Each schema's section carries a guard (row count and schema spec);
restore imports a section only when the live store matches it, under the
live store's current epoch, so epoch invalidation keeps guarding every
later mutation. Entries whose epoch no longer matches the store's
version are not saved.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Tuple

import numpy as np

from geomesa_tpu_torch import resilience
from geomesa_tpu_torch.lake.format import LakeCorruptError, LakeFile, LakeWriter


def _enc_value(w: LakeWriter, v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"t": "bool", "v": bool(v)}
    if isinstance(v, (int, np.integer)):
        return {"t": "int", "v": int(v)}
    if isinstance(v, (float, np.floating)):
        return {"t": "float", "v": float(v)}
    if isinstance(v, str):
        return {"t": "str",
                "r": w.add_array(np.frombuffer(v.encode(), np.uint8))}
    if isinstance(v, bytes):
        return {"t": "bytes", "r": w.add_array(np.frombuffer(v, np.uint8))}
    if isinstance(v, np.ndarray):
        # ravel through the delta encoder (integer-valued grids pack to a
        # few bits a cell); the shape restores on decode
        return {"t": "arr", "r": w.add_array(np.ascontiguousarray(v).ravel()),
                "shape": list(v.shape), "dtype": str(v.dtype)}
    if isinstance(v, tuple):
        return {"t": "tuple", "items": [_enc_value(w, i) for i in v]}
    raise TypeError(f"unpersistable cache value type {type(v).__name__}")


def _dec_value(f: LakeFile, d: Dict[str, Any]) -> Any:
    t = d["t"]
    if t in ("bool", "int", "float"):
        return d["v"]
    if t == "str":
        return f.read_array(d["r"]).tobytes().decode()
    if t == "bytes":
        return f.read_array(d["r"]).tobytes()
    if t == "arr":
        a = f.read_array(d["r"]).astype(np.dtype(d["dtype"]), copy=False)
        return a.reshape(d["shape"])
    if t == "tuple":
        return tuple(_dec_value(f, i) for i in d["items"])
    raise ValueError(f"unknown persisted value type {t!r}")


def save_cache(ds, path: str) -> Dict[str, Any]:
    """Write every schema's current-epoch cache entries to ``path``
    (atomic tmp-then-rename). Returns a per-schema entry-count summary."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    w = LakeWriter(tmp)
    summary: Dict[str, Any] = {}
    try:
        datasets: Dict[str, Any] = {}
        for name, st in ds._stores.items():
            epoch, items = ds.cache.store.export_uid(st.uid)
            if epoch is None or epoch != st.version:
                # the cache predates (or outlived) this store's state:
                # nothing here is provably valid
                summary[name] = 0
                continue
            entries = []
            for key, value in items:
                kr = repr(key)
                try:
                    # a key must survive the repr -> literal_eval round
                    # trip (a numpy scalar reprs as np.int64(5) on numpy 2)
                    if _literal_key(kr) != key:
                        continue
                except (ValueError, SyntaxError):
                    continue  # non-literal key: skip this entry, not all
                try:
                    entries.append([kr, _enc_value(w, value)])
                except TypeError:
                    continue  # unpersistable value kind: skip, not fail
            datasets[name] = {
                "epoch": int(epoch),
                "guard": {"count": int(st.count), "spec": st.ft.spec()},
                "entries": entries,
            }
            summary[name] = len(entries)
        w.finish({"kind": "cache", "datasets": datasets})
    except BaseException:
        w.abort()
        raise
    # the lake writer fsyncs the file; the rename is durable once the
    # parent directory is synced too
    resilience.durable_replace(tmp, path)
    return summary


def restore_cache(ds, path: str) -> Dict[str, Any]:
    """Import persisted cache sections whose guard matches the live
    store, under the live store's current epoch. Returns per-schema
    ``{"restored": n}`` / ``{"skipped": reason}``."""
    f = LakeFile(path)
    if f.footer.get("kind") != "cache":
        raise LakeCorruptError(f"{path}: not a cache persistence file")
    out: Dict[str, Any] = {}
    for name, section in f.footer.get("datasets", {}).items():
        st = ds._stores.get(name)
        if st is None:
            out[name] = {"skipped": "no such schema"}
            continue
        guard = section.get("guard", {})
        if int(guard.get("count", -1)) != int(st.count):
            out[name] = {"skipped": "row count changed"}
            continue
        if guard.get("spec") != st.ft.spec():
            out[name] = {"skipped": "schema changed"}
            continue
        items = []
        skipped = 0
        for key_repr, vd in section.get("entries", []):
            try:
                items.append((_literal_key(key_repr), _dec_value(f, vd)))
            except LakeCorruptError:
                raise  # on-disk corruption is never a benign skip
            except (ValueError, SyntaxError):
                skipped += 1  # one bad entry must not fail the restore
        n = ds.cache.store.import_entries(st.uid, st.version, items)
        out[name] = ({"restored": n, "skipped_entries": skipped}
                     if skipped else {"restored": n})
    return out


def _literal_key(key_repr: str) -> Tuple:
    """Keys are tuples of str / int / float / None / tuples: the
    ``ast.literal_eval``-safe subset, built by the cache itself."""
    return ast.literal_eval(key_repr)
