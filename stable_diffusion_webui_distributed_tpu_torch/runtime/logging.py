"""The port's logging: a console handler, a rotating file and a ring buffer,
every line stamped with the request it was logged under.

A copy of the JAX package's ``runtime/logging.py`` (the port imports
nothing from that package). The port's modules log through
``logging.getLogger(__name__)``, so the port's root logger,
:data:`LOGGER_NAME`, is the one :func:`configure` sets up: a console
handler on stderr (Rich's when it is installed), a 10 MB x 2 rotating
``distributed.log`` under ``SDTPU_LOG_DIR`` (default the working
directory) and the in-memory ring of the last 16 lines that
``GET /internal/status`` serves. :func:`configure` is first-call-wins: a
later call changes only the level. Nothing here writes a file before it
is called, and importing the module configures nothing. Unlike the JAX
package's logger, the port's keeps propagating to the root logger, so an
embedding application's handlers (and pytest's) still see its records.

Every handler carries :class:`RequestIdFilter`: it stamps each record
with the active request's id (``obs/spans.current_request_id``, '' outside
one) and files the line under that id in :class:`RequestLogIndex`, where
the flight recorder (``obs/flightrec.py``) finds a dead request's lines.
A record is filed once however many handlers see it. The request context
is a contextvar: a thread started without ``obs.spans.bind_current``
logs under ''.
"""

from __future__ import annotations

import collections
import logging
import logging.handlers
import os
import threading
import time
from typing import Deque, List

LOGGER_NAME = "stable_diffusion_webui_distributed_tpu_torch"
#: lines the ring buffer keeps
RING_CAPACITY = 16
#: the per-request index's bounds: request ids kept, and lines for each
REQUEST_INDEX_CAPACITY = 64
REQUEST_LINE_CAPACITY = 64

_lock = threading.Lock()
_configured = False  # guarded-by: _lock


class RequestLogIndex:
    """Log lines by request id: the most recent
    ``REQUEST_INDEX_CAPACITY`` ids, ``REQUEST_LINE_CAPACITY`` lines
    each."""

    def __init__(self, max_requests: int = REQUEST_INDEX_CAPACITY,
                 max_lines: int = REQUEST_LINE_CAPACITY):
        self._max_requests = max_requests
        self._max_lines = max_lines
        self._lock = threading.Lock()
        self._lines: "collections.OrderedDict[str, Deque[str]]" = \
            collections.OrderedDict()  # guarded-by: _lock

    def note(self, request_id: str, line: str) -> None:
        with self._lock:
            buf = self._lines.get(request_id)
            if buf is None:
                buf = collections.deque(maxlen=self._max_lines)
                self._lines[request_id] = buf
                while len(self._lines) > self._max_requests:
                    self._lines.popitem(last=False)
            else:
                self._lines.move_to_end(request_id)
            buf.append(line)

    def lines(self, request_id: str) -> List[str]:
        with self._lock:
            return list(self._lines.get(request_id, ()))

    def clear(self) -> None:
        with self._lock:
            self._lines.clear()


_request_index = RequestLogIndex()


def lines_for_request(request_id: str) -> List[str]:
    """The lines logged while ``request_id``'s context was active."""
    return _request_index.lines(str(request_id))


class RequestIdFilter(logging.Filter):
    """Stamps ``record.request_id`` (the active request's id, '' outside
    one) and files the line in the per-request index, once per record."""

    def filter(self, record: logging.LogRecord) -> bool:
        if getattr(record, "_sdtpu_filed", False):
            return True
        rid = ""
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                spans,
            )

            rid = spans.current_request_id() or ""
        except Exception:  # noqa: BLE001 — logging must never fail
            rid = ""
        record.request_id = rid
        record._sdtpu_filed = True
        if rid:
            stamp = time.strftime("%H:%M:%S", time.localtime(record.created))
            try:
                msg = record.getMessage()
            except Exception:  # noqa: BLE001
                msg = str(record.msg)
            _request_index.note(rid, f"{stamp} {record.levelname} {msg}")
        return True


_request_filter = RequestIdFilter()


class RingBufferHandler(logging.Handler):
    """The last ``capacity`` formatted lines, for status pages."""

    def __init__(self, capacity: int = RING_CAPACITY):
        super().__init__()
        self._buf: Deque[str] = collections.deque(maxlen=capacity)
        self._buf_lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
        except Exception:  # pragma: no cover - formatting failure
            self.handleError(record)
            return
        with self._buf_lock:
            self._buf.append(msg)

    def dump(self) -> List[str]:
        """The buffered lines, oldest first."""
        with self._buf_lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._buf_lock:
            self._buf.clear()


_ring_handler = RingBufferHandler()


def get_ring_buffer() -> RingBufferHandler:
    """The process-wide ring buffer handler."""
    return _ring_handler


def _console(use_rich: bool, fmt: logging.Formatter) -> logging.Handler:
    """stderr, never stdout: scripts print machine-read lines there."""
    if use_rich:
        try:
            from rich.console import Console
            from rich.logging import RichHandler

            class BrandedRichHandler(RichHandler):
                """Rich's handler with a branded prefix on a copy of the
                record, so the prefix reaches neither the file nor the
                ring."""

                def emit(self, record: logging.LogRecord) -> None:
                    import copy

                    branded = copy.copy(record)
                    branded.msg = f"[sdtpu] {record.msg}"
                    super().emit(branded)

            return BrandedRichHandler(console=Console(stderr=True),
                                      show_path=False, show_time=True)
        except Exception:  # noqa: BLE001 — rich not installed
            pass
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    return console


def configure(debug: bool = False, log_dir: str | None = None,
              use_rich: bool = True) -> logging.Logger:
    """Set up the port's logger (see the module's docstring); the first
    call wins, later ones set the level only."""
    global _configured
    logger = logging.getLogger(LOGGER_NAME)
    with _lock:
        logger.setLevel(logging.DEBUG if debug else logging.INFO)
        if _configured:
            return logger
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                                "%H:%M:%S")
        handlers = [_console(use_rich, fmt)]
        if log_dir is None:
            from stable_diffusion_webui_distributed_tpu_torch.runtime.config \
                import env_str

            log_dir = env_str("SDTPU_LOG_DIR", ".")
        try:
            file_handler = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, "distributed.log"),
                maxBytes=10 * 1024 * 1024, backupCount=1)
            file_handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s"))
            handlers.append(file_handler)
        except OSError:  # pragma: no cover - unwritable directory
            pass
        _ring_handler.setFormatter(fmt)
        handlers.append(_ring_handler)
        for handler in handlers:
            # a child logger's records reach these handlers, not the
            # logger's own filters: the filter rides on each handler
            handler.addFilter(_request_filter)
            logger.addHandler(handler)
        _configured = True
        return logger


def get_logger() -> logging.Logger:
    """The port's logger, configured on first use (``SDTPU_DEBUG``)."""
    if not _configured:
        from stable_diffusion_webui_distributed_tpu_torch.runtime.config \
            import env_flag

        configure(debug=env_flag("SDTPU_DEBUG"))
    return logging.getLogger(LOGGER_NAME)
