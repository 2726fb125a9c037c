"""Logger with pluggable backends, after the reference's etiLog
(contrib/Log.h:36-180, Log.cpp).

Levels follow log_level_t (Log.h:52): debug, info, warn, error, alert,
emerg, plus the special `trace` level that only the tracer backend records.
Backends: stderr (always, like Logger::logstr's iostream path), syslog
(LogToSyslog), file (LogToFile, "CRC-DABMUX-style" timestamped lines), and
tracer (LogTracer: microseconds-since-startup CSV for offline timing
analysis).  `eti_log` is the singleton, used as

    eti_log.level("info")("input underrun")
    eti_log.register_backend(LogToFile("/tmp/enc.log"))
"""
import sys
import time

DEBUG, INFO, WARN, ERROR, ALERT, EMERG, TRACE, DISCARD = range(8)
_LEVELS = {"debug": DEBUG, "info": INFO, "warn": WARN, "error": ERROR,
           "alert": ALERT, "emerg": EMERG, "trace": TRACE, "discard": DISCARD}
_LEVEL_STR = ["     ", "     ", "WARN ", "ERROR", "ALERT", "EMERG",
              "TRACE", "-----"]


class LogBackend:
    name = "abstract"

    def log(self, level, message):
        raise NotImplementedError


class LogToSyslog(LogBackend):
    """contrib/Log.h:66-85; maps levels onto syslog priorities."""
    name = "SYSLOG"

    def __init__(self, ident="odr-audioenc-tpu"):
        import syslog  # stdlib; LOG_LOCAL0 facility like SYSLOG_FACILITY
        self._syslog = syslog
        syslog.openlog(ident, syslog.LOG_PID, syslog.LOG_LOCAL0)

    def log(self, level, message):
        s = self._syslog
        prio = {DEBUG: s.LOG_DEBUG, INFO: s.LOG_INFO, WARN: s.LOG_WARNING,
                ERROR: s.LOG_ERR, ALERT: s.LOG_ALERT, EMERG: s.LOG_EMERG}
        if level in prio:
            s.syslog(prio[level], message)


class LogToFile(LogBackend):
    """contrib/Log.h:87-101."""
    name = "FILE"

    def __init__(self, filename):
        self._f = open(filename, "a", buffering=1)

    def log(self, level, message):
        if level in (DEBUG, INFO, WARN, ERROR, ALERT, EMERG):
            self._f.write(f"CRC-DABMUX-TPU: {_LEVEL_STR[level].strip() or 'INFO'}: "
                          f"{message}\n")


class LogTracer(LogBackend):
    """contrib/Log.h:103-117: trace-level events with microsecond
    timestamps relative to backend startup, for offline timing analysis."""
    name = "TRACE"

    def __init__(self, filename):
        self._f = open(filename, "a", buffering=1)
        self._t0 = time.monotonic_ns() // 1000
        self._f.write(f"0,TRACER,startup\n")

    def log(self, level, message):
        if level == TRACE:
            us = time.monotonic_ns() // 1000 - self._t0
            self._f.write(f"{us},{message}\n")


class Logger:
    """contrib/Log.h:134-160.  stderr output is built in; additional
    backends attach with register_backend."""

    def __init__(self):
        self._backends = []

    def register_backend(self, backend):
        self._backends.append(backend)

    def log(self, level, message):
        if isinstance(level, str):
            level = _LEVELS[level]
        if level == DISCARD:
            return
        for b in self._backends:
            b.log(level, message)
        if level != TRACE:
            print(f"{_LEVEL_STR[level]} {message}", file=sys.stderr)

    def level(self, level):
        return lambda message: self.log(level, message)


eti_log = Logger()
