"""Opt-in structured JSON logging (MISAKA_LOG_JSON=1, runtime/app.py).

The port's own copy of misaka_tpu/utils/jsonlog.py.  One JSON object per
line on stderr:

  {"time": "2026-08-03T12:00:00.123Z", "level": "INFO",
   "logger": "misaka_tpu_torch.master", "msg": "network was run",
   "route": "/run"}

`route` appears when the record carries one (the HTTP handler passes
`extra={"route": ...}`); `trace_id` appears on every line emitted while a
request trace is in scope on the logging thread (utils/tracespan.py), the
key that joins a log line to its `/debug/requests/<id>` entry; `program`
appears when a record carries one explicitly, or else while a program is
current on the logging thread: the program registry's lease makes the
leased program current for a request's lifetime (runtime/usage.py).
Exceptions land under "exc" as one escaped string, so a traceback stays
one log event.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from misaka_tpu_torch.runtime import usage
from misaka_tpu_torch.utils import tracespan


class JsonFormatter(logging.Formatter):
    """Format every record as one JSON object per line."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        route = getattr(record, "route", None)
        if route:
            obj["route"] = route
        # an explicit extra={"trace_id": ...} wins; otherwise the trace
        # current on the emitting thread (set by the HTTP handlers)
        trace_id = getattr(record, "trace_id", None) or tracespan.current_id()
        if trace_id:
            obj["trace_id"] = trace_id
        # an explicit extra={"program": ...} wins; otherwise the program the
        # registry lease made current on the emitting thread
        program = getattr(record, "program", None) or usage.current_program()
        if program:
            obj["program"] = program
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        # default=str: a log call must never crash on an unserializable arg
        return json.dumps(obj, ensure_ascii=False, default=str)


def install(level: int = logging.INFO, stream=None) -> None:
    """Replace root handlers with one JSON-formatted stderr handler."""
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
