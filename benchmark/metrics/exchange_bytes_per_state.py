"""Mesh exchange (``tpu/mesh_exchange.py`` ``ProcessGroupExchange`` via
``tpu/ranks.py``): bytes every rank handed the collectives during the
traced search, summed over the ranks, per unique state of the mesh."""


def read(rec):
    if rec["width"] < 2 or not rec.get("exchange_bytes"):
        return None
    return rec["exchange_bytes"] / rec["unique"]
