"""Streaming layer: live feature caches over message topics (the Kafka
datastore analog) and hot / cold tiering (the Lambda analog)."""

from geomesa_tpu_torch.stream.messages import GeoMessage, MessageBus, Topic  # noqa: F401
from geomesa_tpu_torch.stream.live import LiveFeatureCache, StreamingDataset  # noqa: F401
from geomesa_tpu_torch.stream.lambda_store import LambdaDataset  # noqa: F401
