"""Seeded CL002: two functions take session.lock and router._lock in
opposite orders — the static graph gets session -> router -> session."""


def claim_then_route(session, router):
    with session.lock:
        with router._lock:
            return router.pick()


def route_then_claim(session, router):
    with router._lock:
        with session.lock:
            return session.queue_depth
