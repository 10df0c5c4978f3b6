"""Batch specs for query-axis batches.

Port of ``geomesa_tpu/planning/batch.py``. A :class:`BatchSpec` packages
what the executor's ``*_batch`` entry points need to serve M *distinct*
viewports in one call: the shared structural template
(``filter/template.py``), its literal-parameterized compiled mask, and the
members' literal vectors padded to the batch bucket. :func:`build_spec` is
the eligibility gate: None unless every member plan compiles to the same
mask structure, so a caller can always fall back to one query at a time
without changing any result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from geomesa_tpu_torch.filter import template as ftpl
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.kernels.registry import bucket_batch


@dataclass
class BatchSpec:
    """One batch's inputs (see the module docstring)."""

    #: structural identity (template key + auths): equal keys, one mask
    key: tuple
    #: the reference's kernel-token component (the full template key)
    token: tuple
    #: the literal-parameterized compiled mask
    bf: "ftpl.BatchedFilter"
    #: member literal vectors, padded to the batch bucket
    lits_f: np.ndarray  # [Mp, nf] float32
    lits_i: np.ndarray  # [Mp, ni] int32
    M: int
    Mp: int


def build_spec(st, plans: List) -> Optional[BatchSpec]:
    """The batch spec of ``plans`` (all over store ``st``), or None when
    they do not share a structural template or the residual needs a host
    refinement. Row visibilities are not served by the port (a query with
    authorizations raises before planning), so the spec is built without
    auths and its keys carry None where the reference's carry them."""
    if not plans:
        return None
    tpls = []
    for p in plans:
        t = ftpl.split_literals(p.filter, st.ft)
        if t is None:
            return None
        tpls.append(t)
    t0 = tpls[0]
    if any(t.key != t0.key for t in tpls[1:]):
        return None
    if any(p.index_name != plans[0].index_name for p in plans[1:]):
        return None
    # the residual's literals are structural (equal keys), compiled once
    residual = compile_filter(t0.residual, st.ft, st.dicts)
    bf = ftpl.compile_batched(t0, residual)
    if not bf.device_exact:
        return None
    M = len(plans)
    Mp = bucket_batch(M)
    lits_f = np.zeros((Mp, len(t0.lits_f)), np.float32)
    lits_i = np.zeros((Mp, len(t0.lits_i)), np.int32)
    for m, t in enumerate(tpls):
        lits_f[m] = t.lits_f
        lits_i[m] = t.lits_i
    return BatchSpec(
        key=("batch",) + t0.key + (None,), token=("qtpl", t0.key, None),
        bf=bf, lits_f=lits_f, lits_i=lits_i, M=M, Mp=Mp,
    )
