"""Faults planted inside the ranks of a ``ranks`` cell (each a
``rank_prepare`` the rank calls before it builds its engine)."""


def exchange_left_out():
    """Each rank keeps the bucket it would send itself and receives
    nothing from the other ranks: the exchange between chips is left
    out."""
    import torch

    from dslabs_tpu_torch.tpu import mesh_exchange

    def local_only(self, xs):
        out = []
        for x in xs:
            y = torch.zeros_like(x)
            y[:, self.rank] = x[:, self.rank]
            out.append(y)
        return out

    mesh_exchange.ProcessGroupExchange.all_to_all_many = local_only
