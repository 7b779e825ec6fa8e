"""Seeded CL009 + CL010: a counter mutated but never declared, and a
cherry-picking stats_export that drops a declared counter."""
import threading


class CountingSession:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0}

    def on_timeout(self):
        with self._lock:
            self.stats["timeouts"] += 1   # CL009: undeclared key

    def stats_export(self):
        with self._lock:
            # CL010: "completed" silently missing from the surface
            return {"submitted": self.stats["submitted"]}
