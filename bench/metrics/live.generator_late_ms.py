"""The largest lateness of the open-loop pusher against its schedule, ms: a
push that blocks on a full ring, or waits for the host, delays the
record, and the record's latency counts from its due time."""


def read(win):
    late = win.extra.get("late_s")
    return None if late is None or len(late) == 0 \
        else float(late.max()) * 1e3
