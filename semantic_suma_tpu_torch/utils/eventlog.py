"""Named experiment/event logs as JSONL (counterpart of
``semantic_suma_tpu/utils/eventlog.py``): open a named log, append typed
events, each flushed to disk as one JSON line. The CLI writes its per-scan
statistics through one :class:`EventLog` of its own."""

from __future__ import annotations

import json
import time
from typing import Any, Optional


class EventLog:
    def __init__(self, name: str, path: Optional[str] = None,
                 mode: str = "a"):
        self.name = name
        self.path = path
        self.events: list[dict] = []
        self._fh = open(path, mode) if path else None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"t": time.time(), "log": self.name, "event": event, **fields}
        self.events.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

