"""TAI-UTC offset for EDI timestamps (contrib/ClockTAI.{h,cpp} equivalent).

Resolution order, mirroring the reference (ClockTAI.cpp:74-79,278-310):
 1. cached bulletin at /var/tmp/odr-leap-seconds.cache (IETF format),
 2. download from the IETF/tzdata URLs (async, graceful failure - this
    environment has no egress),
 3. built-in leap-second table (offset 37 since 2017-01-01, stable since).
"""
import os
import threading
import time

CACHE_PATH = "/var/tmp/odr-leap-seconds.cache"
BULLETIN_URLS = [
    "https://raw.githubusercontent.com/eggert/tz/main/leap-seconds.list",
    "https://www.ietf.org/timezones/data/leap-seconds.list",
]

# NTP epoch (1900) -> POSIX epoch offset
_NTP_POSIX = 2208988800
# built-in table: (posix seconds, TAI-UTC offset); last entry 2017-01-01
_BUILTIN = [(1483228800, 37), (1435708800, 36), (1341100800, 35),
            (1230768000, 34), (1136073600, 33)]


def _parse_bulletin(text):
    entries = []
    expires = None
    for line in text.splitlines():
        if line.startswith("#@"):
            try:
                expires = int(line.split()[1]) - _NTP_POSIX
            except (ValueError, IndexError):
                pass
        elif line and not line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2:
                try:
                    entries.append((int(parts[0]) - _NTP_POSIX, int(parts[1])))
                except ValueError:
                    pass
    entries.sort(reverse=True)
    return entries, expires


class ClockTAI:
    def __init__(self, cache_path=CACHE_PATH):
        self.cache_path = cache_path
        self.entries = list(_BUILTIN)
        self.expires = None
        self._load_cache()
        self._refresh_thread = None

    def _load_cache(self):
        try:
            with open(self.cache_path) as f:
                entries, expires = _parse_bulletin(f.read())
            if entries:
                self.entries = entries
                self.expires = expires
        except OSError:
            pass

    def _download(self):
        import urllib.request
        for url in BULLETIN_URLS:
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    text = r.read().decode()
                entries, expires = _parse_bulletin(text)
                if entries:
                    self.entries = entries
                    self.expires = expires
                    try:
                        with open(self.cache_path, "w") as f:
                            f.write(text)
                    except OSError:
                        pass
                    return True
            except OSError:
                continue
        return False

    def refresh_async(self):
        if self._refresh_thread is None or not self._refresh_thread.is_alive():
            self._refresh_thread = threading.Thread(target=self._download,
                                                    daemon=True)
            self._refresh_thread.start()

    def get_offset(self, at_time=None):
        """TAI-UTC offset in seconds at `at_time` (default: now)."""
        t = at_time if at_time is not None else time.time()
        if self.expires is not None and t > self.expires:
            self.refresh_async()
        for when, off in self.entries:
            if t >= when:
                return off
        return self.entries[-1][1]
