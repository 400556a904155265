"""The odometry step's flag read, ms a scan: the sessions' `step/flags` laps
(`read_flags`: the wait of `to_host` for the card, the host's SVD of the
rotation and its pinned upload; twice on a fallback scan), host clock, over
the window's scans. Moves scans_per_s."""


def read(rec):
    total = rec["laps"].get("step/flags")
    if total is None:
        return None
    return total * 1e3 / rec["scans"]
