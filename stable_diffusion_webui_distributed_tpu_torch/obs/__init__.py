"""Observability: the JAX package's ``obs/``, whole.

The request-observability plane:

- :mod:`.spans`: per-request span trees behind a contextvars request
  context, exported as Chrome trace events (``/internal/trace.json``);
  device spans carry the CUDA-event time of the work they queued.
- :mod:`.flightrec`: the last failed, interrupted, slow or stalled
  requests with their spans and log lines, and what the alert engine and
  the TSDB saw (``/internal/flightrec``).
- :mod:`.watchdog`: stall detection at k x an operation's ETA
  (``SDTPU_WATCHDOG_FACTOR``).
- :mod:`.prometheus`: the metric registry, the fixed-ladder histograms,
  the labelled counters, the alert-state gauge, the ETA gauge and the text
  exposition (``/internal/metrics``).
- :mod:`.perf`: the perf ledger, with MFU against the card's peak
  (``SDTPU_PERF``, ``/internal/perf``), and the executables census of an
  engine's CUDA graphs (``/internal/executables``).
- :mod:`.journal`: the request journal (``SDTPU_JOURNAL``).

The fleet telemetry plane:

- :mod:`.tsdb`: the ring-buffer metric history, its sampler and snapshots,
  and the device-memory readers (``SDTPU_TSDB``, ``/internal/tsdb``).
- :mod:`.alerts`: nine rules (burn rate, EWMA anomaly, windowed increase)
  through pending, firing and resolved (``SDTPU_ALERTS``,
  ``/internal/alerts``).
- :mod:`.notify`: webhook delivery of alert transitions by severity route
  (``SDTPU_NOTIFY_URL``, ``SDTPU_NOTIFY_ROUTES``).
- :mod:`.stitch`: the master's and the remotes' traces on one clock
  (``/internal/stitched-trace.json``).
- :mod:`.fleetlog`: the fleet-merged journal timeline
  (``/internal/fleet/timeline``).
- :mod:`.federation`: the master's prober of its workers' metrics
  (``SDTPU_FEDERATION``, ``/internal/fleet``).
- :mod:`.push`: the workers' delta streams and the master's subscribers
  (``SDTPU_PUSH``, ``/internal/deltas``, ``/internal/push``).

As in the JAX package, nothing starts the plane's daemons by itself: a
World registers itself as the prober's and the push plane's source when
their gates are on, and a caller runs ``tsdb.start_daemon``,
``federation.start_daemon`` and ``push.start_daemons``.
"""
