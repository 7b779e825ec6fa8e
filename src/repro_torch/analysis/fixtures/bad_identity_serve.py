"""Seeded CL011: a serve.py whose drain report lost the accounting
identity — nothing asserts submitted == completed + shed + errors."""


def drain_report(st):
    print("submitted", st["submitted"])
    print("completed", st["completed"])
    return 0
