"""Standing queries: registered viewports kept current incrementally as
mutations apply (``engine.py``), over the shared host evaluator
(``delta.py``) and value-object specs (``spec.py``)."""

from geomesa_tpu_torch.subscribe.engine import (  # noqa: F401
    LiveWindow, StandingGroup, StandingQueryEngine, StoreWindow, UnknownSubscription,
    route_key_of,
)
from geomesa_tpu_torch.subscribe.spec import AGGREGATES, StandingSpec, make_spec  # noqa: F401
