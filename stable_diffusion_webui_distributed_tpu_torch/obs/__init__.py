"""Observability: for now only what the fleet tier reads.

:mod:`.prometheus` holds the fixed-ladder :class:`~.prometheus.Histogram`,
the per-class fleet queue-wait histograms the autoscaler keys on, and the
process-wide ETA mean-percent-error gauge SLO admission falls back to. The
rest of the JAX package's ``obs/`` (spans, journal, flight recorder, the
text exposition, perf ledger, TSDB, alerts) is ROADMAP queue 1 item 10.
"""
