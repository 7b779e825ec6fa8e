"""Seeded CL005: wall-clock read in serving-path code."""
import time


def stamp_request(req):
    req["arrival_ms"] = time.time() * 1e3   # CL005
    return req
