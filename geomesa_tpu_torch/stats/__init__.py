"""Mergeable statistics sketches and the stat DSL (copy of
``geomesa_tpu/stats/``)."""

from geomesa_tpu_torch.stats.parser import parse_stat  # noqa: F401
from geomesa_tpu_torch.stats.sketches import (  # noqa: F401
    CountStat,
    DescriptiveStats,
    EnumerationStat,
    Frequency,
    GroupBy,
    Histogram,
    MinMax,
    SeqStat,
    Stat,
    TopK,
    Z3FrequencyStat,
    Z3HistogramStat,
)
