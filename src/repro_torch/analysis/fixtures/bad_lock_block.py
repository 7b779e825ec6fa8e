"""Seeded CL001: blocking calls inside a with-lock body."""
import threading
import time


class BlockySession:
    def __init__(self):
        self.lock = threading.Lock()

    def flush(self, fut, chunk):
        with self.lock:
            time.sleep(0.01)       # CL001: sleep while holding the lock
            return fut.result()    # CL001: blocking join under the lock
