"""Reading the program's own spans (``sgai.<layer>.<what>`` ranges, which
the port records only while a profiler session records) from the traced
part of a ``--trace 1`` run: the host-and-device trace, ``record["full"]``."""

from __future__ import annotations


def device_ms_per(record: dict, span: str, per: str) -> float | None:
    """Device milliseconds of the kernels launched under the ``span`` ranges
    (by correlation, on each range's thread) over the count of ``per``
    ranges; None where either is absent or no device time falls under them,
    as in a program without these spans."""
    tr = record.get("full")
    if tr is None:
        return None
    ranges, base = tr.ops(span), tr.ops(per)
    spent = sum(k["dur"] for k in tr.launched_under(ranges)) * 1e-3 if ranges else 0.0
    if not base or spent <= 0:
        return None
    return spent / len(base)
