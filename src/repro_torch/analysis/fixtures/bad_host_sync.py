"""Seeded CL001 (torch idiom): a host sync inside the session lock — the
`.item()` waits for every kernel queued on the card while submitters and
the pump queue behind the lock."""
import threading

import torch


class SyncingSession:
    def __init__(self):
        self.lock = threading.RLock()

    def best_score(self, scores: torch.Tensor) -> float:
        with self.lock:
            return scores.max().item()   # CL001: host sync under the lock
