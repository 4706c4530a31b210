"""The device's idle share of the traced window: 1 - (union of the
profiler's device operation intervals) / (host wall time of the window),
in %."""


def read(facts):
    cap = facts.get("capture")
    if cap is None or cap.window_s <= 0:
        return None
    return 100.0 * (1.0 - cap.busy_s / cap.window_s)
