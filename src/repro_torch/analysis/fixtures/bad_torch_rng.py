"""Seeded CL006 (torch idiom): a torch draw with no generator= reads
torch's global generator, which any caller in the process may reseed."""
import torch


def jitter_ms(n: int) -> torch.Tensor:
    return torch.randn(n)   # CL006
