"""Exact stats over a scan (StatsScan analog).

Port of ``geomesa_tpu/kernels/stats_scan.py``. Device-supported sketches
(count, min/max, histogram, descriptive, enumeration, top-k) compute their
masked partial states on the scan's device in plain PyTorch — the
reference's are XLA, not Pallas: masked min / max reductions, int32
scatter-adds (``index_add_``) for the counts, and ``torch.matmul`` for the
descriptive second moments. :func:`device_update_np` is the host twin the
host scan paths run on exact rows. Partial states fold back into the host
``Stat`` objects with :func:`absorb_partials`. Other sketches observe the
gathered matches on the host (the executor's gather path).
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from geomesa_tpu_torch.stats import sketches as sk

#: sketch kinds with a device reduction
DEVICE_KINDS = {"count", "minmax", "histogram", "descriptive", "enumeration", "topk"}


def leaf_stats(stat: sk.Stat) -> List[sk.Stat]:
    return stat.stats if isinstance(stat, sk.SeqStat) else [stat]


def device_supported(stat: sk.Stat, host_only_cols) -> bool:
    for leaf in leaf_stats(stat):
        if leaf.kind not in DEVICE_KINDS:
            return False
        if isinstance(leaf, sk.DescriptiveStats):
            attrs = leaf.attributes
        elif getattr(leaf, "attribute", None) is not None:
            attrs = [leaf.attribute]
        else:
            attrs = []
        if any(a in host_only_cols for a in attrs):
            return False
    return True


def batch_supported(stat: sk.Stat) -> bool:
    """May this stat tree ride a query-axis batch? Every device kind but
    descriptive stats: count, min / max, histogram, enumeration and top-k
    reduce in exact integer (or order-free min / max) arithmetic, so a
    member's partial equals its serial scan's whatever the layout, while
    descriptive sums are f32 and depend on it (a serial scan may compact)."""
    return all(leaf.kind in DEVICE_KINDS - {"descriptive"}
               for leaf in leaf_stats(stat))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a 0-d f32 tensor on ``like``'s device, rounded as
    the reference's weakly typed scalar: the op runs in IEEE f32."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def device_update(stat: sk.Stat, cols: Dict[str, torch.Tensor], mask: torch.Tensor,
                  vocab_sizes: Dict[str, int]) -> List[Dict[str, torch.Tensor]]:
    """The masked partial state tensors of every leaf sketch, on the
    device (one dict per leaf)."""
    out = []
    fm = mask.reshape(-1)
    n = fm.sum()
    inf = float("inf")
    for leaf in leaf_stats(stat):
        if leaf.kind == "count":
            out.append({"count": n})
        elif leaf.kind == "minmax":
            if leaf.attribute + "__x" in cols:
                vx = cols[leaf.attribute + "__x"].reshape(-1)
                vy = cols[leaf.attribute + "__y"].reshape(-1)
                out.append({
                    "count": n,
                    "lo": torch.stack([torch.where(fm, vx, inf).min(),
                                       torch.where(fm, vy, inf).min()]),
                    "hi": torch.stack([torch.where(fm, vx, -inf).max(),
                                       torch.where(fm, vy, -inf).max()]),
                })
            else:
                v = cols[leaf.attribute].reshape(-1)
                out.append({
                    "count": n,
                    "lo": torch.where(fm, v, inf).min(),
                    "hi": torch.where(fm, v, -inf).max(),
                })
        elif leaf.kind == "histogram":
            v = cols[leaf.attribute].reshape(-1)
            if not v.is_floating_point():
                v = v.to(torch.float32)
            # the reference's jitted (v - lo) / (hi - lo) * bins: XLA turns
            # the division by the constant span into a multiply by its f32
            # reciprocal and folds the bin count into it, so the bins are
            # (v - lo) * f32(f32(1 / span) * bins), two IEEE f32 ops here
            c = np.float32(np.float32(1) / np.float32(leaf.hi - leaf.lo)) \
                * np.float32(leaf.bins)
            f = torch.floor((v - _scalar(leaf.lo, v)) * _scalar(float(c), v))
            # XLA converts NaN to 0; clamp then pins +-inf to the edge bins
            f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
            idx = f.clamp(0, leaf.bins - 1).to(torch.int64)
            counts = torch.zeros(leaf.bins, dtype=torch.int32, device=v.device)
            out.append({"counts": counts.index_add_(0, idx, fm.to(torch.int32))})
        elif leaf.kind == "descriptive":
            cs = [cols[a].reshape(-1) for a in leaf.attributes]
            dt = functools.reduce(torch.promote_types, [c.dtype for c in cs])
            mat = torch.stack([c.to(dt) for c in cs], dim=1)
            mw = mat * fm.to(dt)[:, None]
            if dt.is_floating_point:
                s2 = mw.T @ mat
            else:  # integer matmul is not a CUDA op; the same wrapping sums
                d = len(cs)
                s2 = torch.stack([
                    torch.stack([(mw[:, i] * mat[:, j]).sum(dtype=dt) for j in range(d)])
                    for i in range(d)])
            out.append({"count": n, "s1": mw.sum(dim=0, dtype=dt), "s2": s2})
        elif leaf.kind in ("enumeration", "topk"):
            v = cols[leaf.attribute].reshape(-1).to(torch.int32)
            size = vocab_sizes[leaf.attribute]
            idx = v.clamp(0, size - 1).to(torch.int64)
            valid = fm & (v >= 0)
            counts = torch.zeros(size, dtype=torch.int32, device=v.device)
            out.append({"counts": counts.index_add_(0, idx, valid.to(torch.int32))})
        else:  # pragma: no cover - guarded by device_supported
            raise ValueError(f"no device reduction for stat {leaf.kind!r}")
    return out


def device_update_np(stat: sk.Stat, cols: Dict[str, np.ndarray], mask: np.ndarray,
                     vocab_sizes: Dict[str, int]) -> List[Dict[str, np.ndarray]]:
    """Host twin of :func:`device_update` over exact host rows."""
    out = []
    fm = mask.reshape(-1)
    n = fm.sum()
    for leaf in leaf_stats(stat):
        if leaf.kind == "count":
            out.append({"count": n})
        elif leaf.kind == "minmax":
            if leaf.attribute + "__x" in cols:
                vx = cols[leaf.attribute + "__x"].reshape(-1)
                vy = cols[leaf.attribute + "__y"].reshape(-1)
                out.append({
                    "count": n,
                    "lo": np.stack([np.where(fm, vx, np.inf).min(),
                                    np.where(fm, vy, np.inf).min()]),
                    "hi": np.stack([np.where(fm, vx, -np.inf).max(),
                                    np.where(fm, vy, -np.inf).max()]),
                })
            else:
                v = cols[leaf.attribute].reshape(-1)
                out.append({
                    "count": n,
                    "lo": np.where(fm, v, np.inf).min(),
                    "hi": np.where(fm, v, -np.inf).max(),
                })
        elif leaf.kind == "histogram":
            v = cols[leaf.attribute].reshape(-1)
            scaled = (v - leaf.lo) / (leaf.hi - leaf.lo) * leaf.bins
            idx = np.clip(np.floor(scaled), 0, leaf.bins - 1).astype(np.int32)
            out.append({"counts": np.bincount(idx[fm], minlength=leaf.bins)})
        elif leaf.kind == "descriptive":
            mat = np.stack([cols[a].reshape(-1) for a in leaf.attributes], axis=1)
            mw = mat * fm.astype(mat.dtype)[:, None]
            out.append({"count": n, "s1": mw.sum(axis=0), "s2": mw.T @ mat})
        elif leaf.kind in ("enumeration", "topk"):
            v = cols[leaf.attribute].reshape(-1).astype(np.int32)
            size = vocab_sizes[leaf.attribute]
            idx = np.clip(v, 0, size - 1)
            valid = fm & (v >= 0)
            out.append({"counts": np.bincount(idx[valid], minlength=size)})
        else:  # pragma: no cover - guarded by device_supported
            raise ValueError(f"no device reduction for stat {leaf.kind!r}")
    return out


def decode_enum_keys(stat: sk.Stat, dicts) -> sk.Stat:
    """Map enumeration / top-k count keys from dictionary codes to their
    string values (the host-observe path counts raw code columns; the
    device path decodes in :func:`absorb_partials`)."""
    for leaf in leaf_stats(stat):
        if leaf.kind in ("enumeration", "topk"):
            d = dicts.get(leaf.attribute)
            if d is None:
                continue
            enum = leaf if leaf.kind == "enumeration" else leaf._enum
            new = {}
            for k, c in enum.counts.items():
                if isinstance(k, (int, np.integer)):
                    if k < 0:
                        continue  # null codes: dropped (device path parity)
                    key = d.values[k] if k < len(d.values) else int(k)
                else:
                    key = k
                new[key] = new.get(key, 0) + c
            enum.counts = new
    return stat


def absorb_partials(stat: sk.Stat, partials, dicts) -> sk.Stat:
    """Fold partial states (device tensors or host arrays) into the host
    ``Stat`` objects."""
    for leaf, p in zip(leaf_stats(stat), partials):
        p = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
             for k, v in p.items()}
        if leaf.kind == "count":
            leaf.count += int(p["count"])
        elif leaf.kind == "minmax":
            cnt = int(p["count"])
            if cnt == 0:
                continue
            lo, hi = p["lo"], p["hi"]
            leaf.merge(sk.MinMax(
                leaf.attribute,
                lo.tolist() if lo.ndim else float(lo),
                hi.tolist() if hi.ndim else float(hi),
                cnt,
            ))
        elif leaf.kind == "histogram":
            leaf.counts += p["counts"].astype(np.int64)
        elif leaf.kind == "descriptive":
            leaf.count += int(p["count"])
            leaf.s1 += p["s1"].astype(np.float64)
            leaf.s2 += p["s2"].astype(np.float64)
        elif leaf.kind in ("enumeration", "topk"):
            counts = p["counts"].astype(np.int64)
            d = dicts.get(leaf.attribute)
            enum = leaf if leaf.kind == "enumeration" else leaf._enum
            for code, c in enumerate(counts.tolist()):
                if c:
                    key = d.values[code] if d is not None else code
                    enum.counts[key] = enum.counts.get(key, 0) + c
    return stat
