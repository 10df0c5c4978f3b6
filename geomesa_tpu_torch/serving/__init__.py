"""The serving layer: admission, deadline shedding, per-user fair share and
cross-query fusion in front of the dispatch thread (``scheduler.py``,
``fuse.py``)."""

from geomesa_tpu_torch.serving.scheduler import FuseSpec, QueryScheduler, Ticket

__all__ = ["QueryScheduler", "FuseSpec", "Ticket"]
