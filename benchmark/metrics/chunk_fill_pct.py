"""Level loop (``tpu/sharded.py`` ``_level_superstep``): the states the
traced search expanded over the rows its chunk steps could hold."""


def read(rec):
    cap = rec["chunk_steps"] * rec["rows_per_chunk_step"]
    if cap <= 0:
        return None
    return 100.0 * rec["states_expanded"] / cap
