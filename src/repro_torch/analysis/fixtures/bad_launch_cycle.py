"""Seeded CL002 (torch idiom): one function counts a launch under the
session lock, another takes the session lock under the launch counter's
lock — the static graph gets session -> launch -> session, whichever way
`_build.launch_lock` is spelt."""
from repro_torch.kernels import _build
from repro_torch.kernels._build import launch_lock


def count_under_session(session, wrapper):
    with session.lock:
        with _build.launch_lock:
            wrapper.launches += 1


def depth_under_launch(session):
    with launch_lock:
        with session.lock:          # CL002: closes the cycle
            return session.queue_depth()
