"""The benchmark's general parts: what `bench/run.py` reads and how it
reports, beside the drivers (one a traffic kind, `bench/drivers/`) and the
metric readers (one a metric, `bench/metrics/`) that it finds by name."""
