"""Observability: the request-observability plane of the JAX package's
``obs/``.

- :mod:`.spans`: per-request span trees behind a contextvars request
  context, exported as Chrome trace events (``/internal/trace.json``);
  device spans carry the CUDA-event time of the work they queued.
- :mod:`.flightrec`: the last failed, interrupted, slow or stalled
  requests with their spans and log lines (``/internal/flightrec``).
- :mod:`.watchdog`: stall detection at k x an operation's ETA
  (``SDTPU_WATCHDOG_FACTOR``).
- :mod:`.prometheus`: the metric registry, the fixed-ladder histograms,
  the labelled counters, the ETA gauge and the text exposition
  (``/internal/metrics``).
- :mod:`.perf`: the perf ledger, with MFU against the card's peak
  (``SDTPU_PERF``, ``/internal/perf``).
- :mod:`.tsdb`: the device-memory readers.
- :mod:`.journal`: the request journal (``SDTPU_JOURNAL``).

The JAX package's TSDB store, alerts, notify, fleetlog, stitch,
federation and push are ROADMAP queue 1 item 10's next slice.
"""
