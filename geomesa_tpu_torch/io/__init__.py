"""IO: the Avro codec (``avro_io.py``) that the Confluent stream edge
frames; the Arrow, Parquet and export formats are not ported yet."""
