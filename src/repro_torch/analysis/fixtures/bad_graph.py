"""Seeded CL003 (torch idiom): a CUDA graph captured per call outside the
blessed capture modules — a recording per call site and shape that
warmup never made."""
import torch


def replay_step(graph, step, x):
    with torch.cuda.graph(graph):   # CL003
        y = step(x)
    graph.replay()
    return y
