"""Frontier packing (``tpu/packing.py``): bytes of one stored frontier
row in the engine's pack layout."""


def read(rec):
    return rec["plane_words"] * 4 if rec["plane_words"] else None
