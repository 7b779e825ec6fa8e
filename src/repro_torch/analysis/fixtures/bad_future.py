"""Seeded CL008: a RankFuture is constructed and dropped — no _pending
queue, no resolve/fail path, so launch.serve's zero-dropped gate would
count it as never resolved."""


class RankFuture:
    def __init__(self, request_id):
        self.request_id = request_id


def submit_and_forget(req):
    fut = RankFuture(req["id"])   # CL008
    return fut is not None
