"""Device layer in the live cell: the reading of ``device_idle_pct``, which
moves ``frame_p95_ms`` here."""

from benchmark import spec

read = spec.load_reader("device_idle_pct")
