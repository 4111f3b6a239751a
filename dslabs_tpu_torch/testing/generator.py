"""NodeGenerator: serializable factory for servers, clients, and workloads.

Re-design of framework/tst/.../NodeGenerator.java:40-178.  States use it to
construct nodes on ``add_server``/``add_client_worker``.
"""

from __future__ import annotations

from typing import Callable, Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.testing.workload import Workload

__all__ = ["NodeGenerator"]


class NodeGenerator:

    def __init__(self,
                 server_supplier: Optional[Callable[[Address], Node]] = None,
                 client_supplier: Optional[Callable[[Address], Node]] = None,
                 workload_supplier: Optional[Callable[[Address], Workload]] = None):
        self._server_supplier = server_supplier
        self._client_supplier = client_supplier
        self._workload_supplier = workload_supplier

    def server(self, address: Address) -> Node:
        if self._server_supplier is None:
            raise RuntimeError("NodeGenerator has no server supplier")
        return self._server_supplier(address)

    def client(self, address: Address) -> Node:
        if self._client_supplier is None:
            raise RuntimeError("NodeGenerator has no client supplier")
        return self._client_supplier(address)

    def workload(self, address: Address) -> Workload:
        if self._workload_supplier is None:
            raise RuntimeError("NodeGenerator has no workload supplier")
        return self._workload_supplier(address)

    def has_workload_supplier(self) -> bool:
        return self._workload_supplier is not None

    def with_workload(self, workload_or_supplier) -> "NodeGenerator":
        """Return a copy with a different workload supplier."""
        supplier = (workload_or_supplier if callable(workload_or_supplier)
                    else (lambda _addr: workload_or_supplier))
        return NodeGenerator(self._server_supplier, self._client_supplier,
                             supplier)
