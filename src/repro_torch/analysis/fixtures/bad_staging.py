"""Seeded CL004 (torch idiom): a hand-built staging batch of torch
tensors with the exact {"x","q","mask","m_q"} layout outside the
bucket/warmup code."""
import torch


def handmade_batch(b, g, d_x, d_q):
    return {"x": torch.zeros(b, g, d_x),    # CL004
            "q": torch.zeros(b, d_q),
            "mask": torch.zeros(b, g),
            "m_q": torch.ones(b)}
