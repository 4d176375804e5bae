"""h2d_gib: GiB the program fetched from the host a step, from the out-of-core
layer's own counter (``db.counters()["spill"]["fetched_bytes"]``)."""


def read(t):
    moved = t.counter_delta("spill", "fetched_bytes")
    if not moved or t.steps <= 0:
        return None
    return moved / t.steps / 2 ** 30
