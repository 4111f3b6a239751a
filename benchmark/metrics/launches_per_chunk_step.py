"""Expand (``tpu/engine.py`` ``_expand_chunk`` over the compiled
handlers): device launches of the traced search per chunk step, from the
profiler's trace (copies and fills not counted)."""


def read(rec):
    n = rec["device"]["launches"]
    if n <= 0 or rec["chunk_steps"] <= 0:
        return None
    return n / rec["chunk_steps"]
