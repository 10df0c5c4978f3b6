"""The lake tier: partition spill snapshots as footer-indexed files of row
groups with per-group statistics, so a scan prunes row groups before any
payload byte loads (copy of ``geomesa_tpu/lake``, cut to the snapshot
tier: ``format`` is the container and codecs, ``snapshot`` the partition
files, ``residency`` the join's cross-chunk cache)."""
