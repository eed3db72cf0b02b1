"""Observability: what the fleet tier, the stage-graph executor and the
scenario engine read.

:mod:`.prometheus` holds the fixed-ladder :class:`~.prometheus.Histogram`,
the per-class fleet queue-wait histograms the autoscaler keys on, the
process-wide ETA mean-percent-error gauge SLO admission falls back to, the
stage-graph node histograms and the chaos plan's fault counter.
:mod:`.journal` is the request journal (``SDTPU_JOURNAL``). The rest of the
JAX package's ``obs/`` (spans, flight recorder, watchdog, the text
exposition, perf ledger, TSDB, alerts) is ROADMAP queue 1 item 10.
"""
