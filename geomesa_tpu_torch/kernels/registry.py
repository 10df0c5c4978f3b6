"""Shape buckets of the scan.

Copy of ``bucket_batch`` and ``bucket_count`` from
``geomesa_tpu/kernels/registry.py``. The JAX package buckets shapes so
that one traced kernel serves many calls; eager PyTorch traces nothing,
but the buckets still fix the padded window count of a scan and the padded
member count of a query-axis batch, and with them the results' layout.
The reference's ``KernelRegistry`` (its trace cache) has no counterpart
here.
"""

from __future__ import annotations

#: floor of the padded per-shard window count (geomesa.compact.bucket.floor)
WINDOW_BUCKET_FLOOR = 8


def bucket_batch(n: int) -> int:
    """Pad a batch's member count to the next power of two. Padded
    members carry empty windows and zero literals; their results are
    dropped."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_count(n: int, floor: int = WINDOW_BUCKET_FLOOR) -> int:
    """Pad a per-shard window count to its shape bucket: the next power of
    two, floored at ``floor``."""
    n = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return max(n, floor)
