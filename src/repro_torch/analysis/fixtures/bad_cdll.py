"""Seeded CL003 (torch idiom): the kernel library loaded outside
kernels/_build.py — a second, unkeyed load path warmup never runs."""
import ctypes


def load_kernels(path):
    return ctypes.CDLL(str(path))   # CL003
