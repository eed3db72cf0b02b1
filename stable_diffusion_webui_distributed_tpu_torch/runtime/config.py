"""Environment knobs of the serving layer.

A copy of the env helpers of the JAX package's ``runtime/config.py`` that
the port's serving layer reads; the knobs keep their names and defaults:

- ``SDTPU_SERVING`` (flag, on): ``ApiServer`` puts a ``ServingDispatcher``
  in front of a bare engine.
- ``SDTPU_COALESCE_WINDOW`` (seconds, 0.05): how long a group's leader
  waits for compatible requests to join it.
- ``SDTPU_BUCKET_LADDER`` (``WxH`` comma list, ``512x512,640x640,768x768,
  1024x1024``) and ``SDTPU_BATCH_LADDER`` (int comma list, ``1,2,4,8``):
  the shapes and batch sizes requests are padded up to.
- ``SDTPU_RAGGED`` (flag, off): ragged dispatch; ``SDTPU_RAGGED_LADDER``
  (``WxH`` comma list) optionally replaces the shape ladder for it.

Malformed values warn and fall back to the default: a bad knob must not
take the server down.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional


def env_flag(name: str, default: bool = False) -> bool:
    """'' -> default; '0'/'false'/'off'/'no' -> False; anything else ->
    True."""
    raw = os.environ.get(name, "").strip().lower()
    if raw == "":
        return default
    return raw not in ("0", "false", "off", "no")


def env_parsed(name: str, parse, default, what: str = "value"):
    """Unset -> default; unparseable (``parse`` raises ValueError or
    TypeError) -> a UserWarning and the default."""
    raw = os.environ.get(name, "")
    if raw.strip() == "":
        return default
    try:
        return parse(raw)
    except (ValueError, TypeError) as e:
        warnings.warn(f"{name}={raw!r} is not a valid {what} ({e}); "
                      f"using default {default!r}", stacklevel=3)
        return default


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    return env_parsed(name, lambda raw: float(raw.strip()), default, "float")
