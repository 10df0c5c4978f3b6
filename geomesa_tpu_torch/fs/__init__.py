"""Storage roots: the write-ahead mutation journal (copy of
``geomesa_tpu/fs/journal.py``, cut to what ``GeoDataset`` durability
uses)."""
