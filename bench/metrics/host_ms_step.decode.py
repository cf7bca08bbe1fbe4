"""Host milliseconds a committed decode step: the scheduler's own
``host_ms_total`` counter (each poll's wall time less its wait on the
token readback) over the decode steps the window committed."""


def read(rec):
    if rec["mode"] != "decode" or not rec["steps"]:
        return None
    return rec["host_ms"] / rec["steps"]
