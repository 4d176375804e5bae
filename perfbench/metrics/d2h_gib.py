"""d2h_gib: GiB the program copied back to the host a step, from the
out-of-core layer's own counter (``db.counters()["spill"]["merged_bytes"]``:
the live rows of each wave's gradient leaves of a streamed relation)."""


def read(t):
    moved = t.counter_delta("spill", "merged_bytes")
    if not moved or t.steps <= 0:
        return None
    return moved / t.steps / 2 ** 30
