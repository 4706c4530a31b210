"""host_enqueue_ms.train: host milliseconds a cohort step call takes to
return, the device idle when it starts (a sync before each call, none
after), averaged over the traced rounds. Host clock."""


def read(facts):
    times = facts.get("host_enqueue_s") or []
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
