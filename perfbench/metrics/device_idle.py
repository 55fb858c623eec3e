"""Share of the proves' wall time in which the device runs nothing: one minus
the union of the profiler's device intervals inside the proves, over the
proves' length."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    t = bundle["trace"]
    if not t.get("device_events") or not t.get("prove_s"):
        return None
    return 100.0 * (1.0 - t["prove_busy_s"] / t["prove_s"])
