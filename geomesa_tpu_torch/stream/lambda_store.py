"""Lambda store: a hot streaming window and a cold persisted tier, queried
as one.

Copy of ``geomesa_tpu/stream/lambda_store.py``. Writes land in the
transient (stream) tier at once and migrate to the persistent store once
older than an age threshold; queries merge the two tiers with the
transient copy winning; stats merge across tiers. The persistent tier is a
``GeoDataset`` on the card, so its queries run the port's kernels (a
polygon filter launches ``pip.cu``); the merged density bins on that
dataset's device with the reference's f64 pixel mapping.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from geomesa_tpu_torch.api.dataset import GeoDataset
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stream.live import StreamingDataset


class LambdaDataset:
    """Hot/cold hybrid datastore (LambdaDataStore analog)."""

    def __init__(self, persistent: Optional[GeoDataset] = None,
                 transient: Optional[StreamingDataset] = None,
                 persist_age_ms: int = 60_000, device=None):
        # each tier made here runs on ``device`` (None: the CUDA card)
        self.persistent = persistent or GeoDataset(device=device)
        self.transient = transient or StreamingDataset(device=device)
        self.persist_age_ms = persist_age_ms

    # -- schema ------------------------------------------------------------
    def create_schema(self, name_or_ft, spec: Optional[str] = None) -> FeatureType:
        ft = self.transient.create_schema(name_or_ft, spec)
        self.persistent.create_schema(FeatureType.from_spec(ft.name, ft.spec()))
        return ft

    def list_schemas(self) -> List[str]:
        return self.transient.list_schemas()

    # -- writes (always to the transient tier first) ------------------------
    def write(self, name: str, data: Dict[str, Sequence], fids: Sequence[str],
              ts_ms: Optional[Sequence[int]] = None):
        self.transient.write(name, data, fids, ts_ms)

    # -- tier migration ------------------------------------------------------
    def run_persistence(self, name: Optional[str] = None,
                        now_ms: Optional[int] = None) -> int:
        """Move transient features older than the age threshold into the
        persistent store. Returns the number migrated."""
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        cutoff = now_ms - self.persist_age_ms
        moved = 0
        for nm in [name] if name else self.transient.list_schemas():
            self.transient.poll(nm)
            cache = self.transient.cache(nm)
            with cache._lock:
                old = [
                    (fid, ts, attrs)
                    for fid, (ts, attrs) in cache._state.items()
                    if ts <= cutoff
                ]
            if not old:
                continue
            ft = self.transient.get_schema(nm)
            keys = [a.name for a in ft.attributes]
            data = {k: [attrs.get(k) for _, _, attrs in old] for k in keys}
            # point geometries arrive as [x, y] pairs; null geometry -> NaN
            g = ft.geom_field
            if g is not None and ft.attr(g).is_point:
                pairs = data.pop(g)
                data[g + "__x"] = np.array(
                    [np.nan if p is None else float(p[0]) for p in pairs], np.float64
                )
                data[g + "__y"] = np.array(
                    [np.nan if p is None else float(p[1]) for p in pairs], np.float64
                )
            fids = [fid for fid, _, _ in old]
            # an updated feature may age out again: replace, don't duplicate
            pst = self.persistent._store(nm)
            if pst.count:
                from geomesa_tpu_torch.filter import ir as fir
                from geomesa_tpu_torch.filter.compile import compile_filter

                # the port's compiled filters take torch by default: the
                # store's delete wants the host mask
                cf = compile_filter(fir.IdIn(tuple(fids)), pst.ft, pst.dicts)
                pst.delete(lambda cols: cf.exact_mask(cols, len(cols["__fid__"])))
            self.persistent.insert(nm, data, fids)
            self.persistent.flush(nm)
            # evict only if the entry is still the snapshot we persisted —
            # a concurrent newer update must survive in the hot tier
            with cache._lock:
                for fid, ts, _ in old:
                    cur = cache._state.get(fid)
                    if cur is not None and cur[0] == ts:
                        del cache._state[fid]
                        cache._invalidate()
            moved += len(old)
        return moved

    # -- merged reads ---------------------------------------------------------
    def dicts(self, name: str):
        """The merged result's dictionary space = the transient tier's."""
        return self.transient.cache(name).dicts

    def _recode_cold(self, name: str, cold: ColumnBatch) -> ColumnBatch:
        """Re-encode the persistent tier's string codes into the transient
        dictionary space so merged columns share one vocabulary."""
        ft = self.transient.get_schema(name)
        cold_dicts = self.persistent._store(name).dicts
        hot_dicts = self.dicts(name)
        cols = dict(cold.columns)
        for a in ft.attributes:
            if a.type == "string" and a.name in cols:
                d_cold = cold_dicts.get(a.name)
                if d_cold is None:
                    continue
                decoded = d_cold.decode(cols[a.name])
                d_hot = hot_dicts.setdefault(a.name, type(d_cold)())
                cols[a.name] = d_hot.encode(decoded)
        return ColumnBatch(cols, cold.n)

    def query(self, name: str, ecql: str = "INCLUDE") -> ColumnBatch:
        """Transient + persistent results; transient wins on duplicate fid."""
        hot = self.transient.query(name, ecql)
        cold = self._recode_cold(name, self.persistent.query(name, ecql).batch)
        if hot.n == 0:
            return cold
        if cold.n == 0:
            return hot
        # normalize both tiers to str: the fid column layout ('S' vs 'U')
        # is content-dependent, and a bytes set never matches str elements
        from geomesa_tpu_torch.schema.columns import fid_strs

        hot_fids = set(fid_strs(hot.columns["__fid__"]).tolist())
        keep = np.array(
            [f not in hot_fids for f in fid_strs(cold.columns["__fid__"])],
            dtype=bool,
        )
        cold = cold.select(keep)
        # align to the shared column set (key columns may differ per tier)
        common = [k for k in hot.columns if k in cold.columns]
        return ColumnBatch.concat([
            ColumnBatch({k: hot.columns[k] for k in common}, hot.n),
            ColumnBatch({k: cold.columns[k] for k in common}, cold.n),
        ])

    def count(self, name: str, ecql: str = "INCLUDE") -> int:
        return int(self.query(name, ecql).n)

    def density(self, name: str, ecql: str = "INCLUDE",
                bbox=(-180, -90, 180, 90), width: int = 256,
                height: int = 256) -> np.ndarray:
        """Merged density over both tiers with the same duplicate resolution
        as query(): hot wins. One grid over the merged columns keeps
        feature results and map overlays consistent; it bins on the
        persistent dataset's device with the f64 pixel mapping of the host
        rows, as the reference bins them with NumPy."""
        from geomesa_tpu_torch.kernels import density as kdensity

        merged = self.query(name, ecql)
        if merged.n == 0:
            return np.zeros((height, width), np.float32)
        g = self.transient.get_schema(name).geom_field
        dev = self.persistent.device
        return kdensity.density_grid_f64(
            torch.from_numpy(np.asarray(merged.columns[g + "__x"], np.float64)).to(dev),
            torch.from_numpy(np.asarray(merged.columns[g + "__y"], np.float64)).to(dev),
            torch.ones(merged.n, dtype=torch.bool, device=dev), tuple(bbox), width, height,
        ).cpu().numpy()

    def stats(self, name: str, stat_spec: str, ecql: str = "INCLUDE"):
        """Merged stats: observe both tiers into one sketch (LambdaStats)."""
        from geomesa_tpu_torch.kernels.stats_scan import decode_enum_keys
        from geomesa_tpu_torch.stats import parse_stat

        stat = parse_stat(stat_spec)
        merged = self.query(name, ecql)
        if merged.n:
            stat.observe(merged.columns)
            decode_enum_keys(stat, self.dicts(name))
        return stat
