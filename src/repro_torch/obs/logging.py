"""The one structured logger every layer logs through.

A copy of the reference package's ``obs/logging.py`` (standard library
only); the port logs under its own ``repro_torch.*`` namespace.

``get_logger("serve.engine")`` returns a :class:`StructuredLogger`
bound to a *component*; every record renders as::

    [component] event key=value key=value ...

with the bound fields (host_id, and a ``stamp=(step, origin, seq)``
logical-clock triple when the caller has one) appended in a stable
order, so fleet logs from different hosts interleave greppably.  It
wraps stdlib ``logging`` (namespace ``repro_torch.*``) — handler/level
configuration composes with whatever the embedding app set up;
:func:`configure` is the one-liner the CLIs under ``launch/`` call to
get message-only lines on stderr/stdout.

Human/progress output goes through this module; machine-readable
artifacts (final JSON lines) go through ``sys.stdout.write``.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

_ROOT = "repro_torch"
_global_fields: Dict[str, Any] = {}


def set_host(host_id: int) -> None:
    """Bind ``host=<id>`` into every logger process-wide (the
    multi-host runtime calls this once at initialize)."""
    _global_fields["host"] = int(host_id)


def _quote(v: Any) -> str:
    s = str(v)
    return f'"{s}"' if (" " in s or "=" in s) else s


class StructuredLogger:
    """Component-bound, field-carrying logger facade."""

    def __init__(self, component: str,
                 fields: Optional[Dict[str, Any]] = None):
        self.component = component
        self.fields = dict(fields or {})
        self._log = logging.getLogger(f"{_ROOT}.{component}")

    def bind(self, **fields) -> "StructuredLogger":
        """A child logger with extra permanent fields (host_id, rid,
        section ...)."""
        return StructuredLogger(self.component,
                                {**self.fields, **fields})

    def render(self, event: str, fields: Dict[str, Any]) -> str:
        merged = {**_global_fields, **self.fields, **fields}
        stamp = merged.pop("stamp", None)
        if stamp is not None:
            merged["stamp"] = "/".join(str(x) for x in stamp)
        kv = " ".join(f"{k}={_quote(v)}" for k, v in merged.items())
        head = f"[{self.component}] {event}"
        return f"{head} {kv}" if kv else head

    def _emit(self, level: int, event: str, fields: Dict[str, Any],
              exc_info: bool = False):
        if self._log.isEnabledFor(level):
            self._log.log(level, "%s", self.render(event, fields),
                          exc_info=exc_info)

    def debug(self, event: str, **fields):
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields):
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields):
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields):
        self._emit(logging.ERROR, event, fields)

    def exception(self, event: str, **fields):
        self._emit(logging.ERROR, event, fields, exc_info=True)


def get_logger(component: str, **fields) -> StructuredLogger:
    return StructuredLogger(component, fields)


def configure(level: str = "info", stream=None) -> None:
    """Message-only lines for the ``repro_torch.*`` namespace — what the
    ``launch/`` CLIs call so progress output reaches the terminal
    without double-configuring an embedding app's logging."""
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper()))
    if not any(getattr(h, "_repro_obs", False) for h in root.handlers):
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter("%(message)s"))
        h._repro_obs = True
        root.addHandler(h)
        root.propagate = False
