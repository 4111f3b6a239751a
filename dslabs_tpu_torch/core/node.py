"""The Node base class — the core of the public protocol API.

Re-design of framework/src/dslabs/framework/Node.java:106-602 for Python:

  * Handlers are resolved **by method name from the message/timer class name**:
    a message of class ``Foo`` is delivered to ``handle_Foo(message, sender)``;
    a timer of class ``Bar`` fires ``on_Bar(timer)`` (reference: reflective
    lookup of ``handleFoo``/``onBar``, Node.java:372-373, 449-450).  Lookup is
    cached per (class, name).
  * ``send``/``broadcast``/``set_timer`` go through configured hooks wired in
    by the execution engine (``config``, Node.java:582-601); sub-nodes route
    through their parent (Node.java:264-268, 307-310, 335-339).
  * Sub-node hierarchy via ``add_sub_node`` (Node.java:149-171); delivery to a
    ``SubAddress`` walks the path from the root node (Node.java:484-503).
  * Local immediate delivery between nodes of one hierarchy:
    ``handle_message_local`` (no cloning, exceptions propagate —
    Node.java:391-427).

Contract for protocol authors (Node.java:50-101): handlers are sequential,
deterministic, non-blocking; node state must be structurally comparable and
deep-clonable — inherited here from :class:`StructEq`.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from dslabs_tpu_torch.core.address import Address, SubAddress
from dslabs_tpu_torch.core.types import Message, Timer
from dslabs_tpu_torch.utils.structural import StructEq

LOG = logging.getLogger("dslabs.node")

__all__ = ["Node", "NodeConfig"]

# Handler method cache: (class, handler_name) -> bound-method-name or None
_HANDLER_CACHE: Dict[Tuple[type, str], Optional[str]] = {}


class NodeConfig:
    """Hooks wired into a root node by the execution engine.

    Mirrors the five config parameters of Node.config (Node.java:582-601).
    ``message_adder(from, to, message)``, ``batch_message_adder(from, tos,
    message)``, ``timer_adder(from, timer, min_ms, max_ms)``,
    ``throwable_catcher(exc)``.
    """

    __slots__ = ("message_adder", "batch_message_adder", "timer_adder",
                 "throwable_catcher", "log_exceptions")

    def __init__(self,
                 message_adder: Optional[Callable[[Address, Address, Message], None]],
                 timer_adder: Callable[[Address, Timer, int, int], None],
                 throwable_catcher: Optional[Callable[[BaseException], None]] = None,
                 batch_message_adder: Optional[
                     Callable[[Address, Tuple[Address, ...], Message], None]] = None,
                 log_exceptions: bool = True):
        self.message_adder = message_adder
        self.batch_message_adder = batch_message_adder
        self.timer_adder = timer_adder
        self.throwable_catcher = throwable_catcher
        self.log_exceptions = log_exceptions


class Node(StructEq):
    """Base class of every protocol actor."""

    # Config hooks are runtime wiring, not state: dropped on clone
    # (the engine re-configures each cloned node), excluded from equality.
    __deepcopy_skip__ = ("_config",)

    def __init__(self, address: Address):
        self.address = address
        self.sub_nodes: Dict[str, "Node"] = {}
        self._parent: Optional["Node"] = None
        self._config: Optional[NodeConfig] = None

    # -- StructEq: exclude the (immutable) address from the hashed field set is
    #    unnecessary; it is constant per node slot.  _parent/_config excluded
    #    automatically (underscore prefix).

    def init(self) -> None:
        """Initialization hook; may send messages and set timers."""
        raise NotImplementedError

    # ------------------------------------------------------------------ sends

    def send(self, message: Message, to: Address) -> None:
        self._send(message, self.address, to)

    def broadcast(self, message: Message, to: Iterable[Address]) -> None:
        tos = tuple(to)
        if not tos:
            return
        self._broadcast(message, self.address, tos)

    def set_timer(self, timer: Timer, min_ms: int, max_ms: Optional[int] = None) -> None:
        """Set a timer to fire between min_ms and max_ms (inclusive), chosen
        uniformly at random by the real-time runner; the model checker treats
        the bounds as a partial order (Node.java:218-248)."""
        if max_ms is None:
            max_ms = min_ms
        if min_ms > max_ms:
            raise ValueError("Minimum timer length greater than maximum")
        if min_ms < 1:
            raise ValueError("Minimum timer length < 1ms")
        self._set(timer, min_ms, max_ms, self.address)

    def _send(self, message: Message, frm: Address, to: Address) -> None:
        if message is None or to is None:
            LOG.error("Attempted to send null message/address from %s", frm)
            return
        if self._parent is not None and self._config is None:
            self._parent._send(message, frm, to)
            return
        cfg = self._config
        if cfg is None:
            LOG.error("Send before node configured: %s -> %s", frm, to)
            return
        if cfg.message_adder is not None:
            cfg.message_adder(frm, to, message)
        elif cfg.batch_message_adder is not None:
            cfg.batch_message_adder(frm, (to,), message)
        else:
            LOG.error("Node configured without message adder")

    def _broadcast(self, message: Message, frm: Address, tos: Tuple[Address, ...]) -> None:
        if message is None or any(a is None for a in tos):
            LOG.error("Attempted to broadcast null from %s", frm)
            return
        if self._parent is not None and self._config is None:
            self._parent._broadcast(message, frm, tos)
            return
        cfg = self._config
        if cfg is None:
            LOG.error("Broadcast before node configured from %s", frm)
            return
        if cfg.batch_message_adder is not None:
            cfg.batch_message_adder(frm, tos, message)
        elif cfg.message_adder is not None:
            for a in tos:
                cfg.message_adder(frm, a, message)
        else:
            LOG.error("Node configured without message adder")

    def _set(self, timer: Timer, min_ms: int, max_ms: int, frm: Address) -> None:
        if timer is None:
            LOG.error("Attempted to set null timer for %s", frm)
            return
        if self._parent is not None and self._config is None:
            self._parent._set(timer, min_ms, max_ms, frm)
            return
        cfg = self._config
        if cfg is None:
            LOG.error("Timer set before node configured for %s", frm)
            return
        cfg.timer_adder(frm, timer, min_ms, max_ms)

    # -------------------------------------------------------------- hierarchy

    def add_sub_node(self, sub_node: "Node") -> None:
        sa = sub_node.address
        if not (isinstance(sa, SubAddress) and sa.parent == self.address):
            raise ValueError(
                "Sub-node address must be a sub-address of this node's address")
        if sub_node._config is not None:
            raise ValueError("Cannot add node already configured as stand-alone")
        if sa.sub_id in self.sub_nodes:
            raise ValueError(f"Node already has sub-node with id {sa.sub_id}")
        sub_node._parent = self
        self.sub_nodes[sa.sub_id] = sub_node

    def _resolve(self, destination: Address) -> Optional["Node"]:
        """Walk from the hierarchy root to the node owning ``destination``."""
        n: Node = self
        while n._parent is not None:
            n = n._parent
        path = []
        d = destination
        while isinstance(d, SubAddress):
            path.append(d.sub_id)
            d = d.parent
        for sub_id in reversed(path):
            child = n.sub_nodes.get(sub_id)
            if child is None:
                LOG.error("Could not find sub-node %s of %s", sub_id, n.address)
                return None
            n = child
        return n

    # --------------------------------------------------------------- delivery

    def deliver_message(self, message: Message, sender: Address,
                        destination: Optional[Address] = None) -> None:
        """Framework entry point: dispatch a message to its handler.

        Exceptions from the handler are caught and routed to the configured
        throwable catcher (Node.java:387-389, 546-560)."""
        self._handle_message_internal(message, sender,
                                      destination or self.address,
                                      handle_exceptions=True)

    def handle_message_local(self, message: Message,
                             destination: Optional[Address] = None) -> Any:
        """Immediate local delivery within one root hierarchy (parent <->
        sub-node communication).  NOT cloned; exceptions propagate; the
        handler's return value is passed back (Node.java:391-427)."""
        return self._handle_message_internal(
            message, self.address, destination or self.address,
            handle_exceptions=False)

    def deliver_timer(self, timer: Timer,
                      destination: Optional[Address] = None) -> None:
        """Framework entry point: fire a timer handler."""
        self._on_timer_internal(timer, destination or self.address,
                                handle_exceptions=True)

    def on_timer_local(self, timer: Timer,
                       destination: Optional[Address] = None) -> None:
        """Invoke a timer handler immediately (Node.java:467-476)."""
        self._on_timer_internal(timer, destination or self.address,
                                handle_exceptions=False)

    def _handle_message_internal(self, message: Message, sender: Address,
                                 destination: Address, handle_exceptions: bool) -> Any:
        if message is None:
            LOG.error("Null message to %s", destination)
            return None
        if self.address.root_address() != destination.root_address():
            LOG.error("Message destined to %s delivered to %s; dropping",
                      destination, self.address)
            return None
        handler = "handle_" + type(message).__name__
        return self._call(destination, handler, handle_exceptions,
                          message, sender)

    def _on_timer_internal(self, timer: Timer, destination: Address,
                           handle_exceptions: bool) -> None:
        if timer is None:
            LOG.error("Null timer to %s", destination)
            return
        if self.address.root_address() != destination.root_address():
            LOG.error("Timer destined to %s delivered to %s; dropping",
                      destination, self.address)
            return
        handler = "on_" + type(timer).__name__
        self._call(destination, handler, handle_exceptions, timer)

    def _call(self, destination: Address, name: str, handle_exceptions: bool,
              *args: Any) -> Any:
        n = self._resolve(destination)
        if n is None:
            return None
        cls = type(n)
        key = (cls, name)
        if key not in _HANDLER_CACHE:
            _HANDLER_CACHE[key] = name if hasattr(n, name) else None
        resolved = _HANDLER_CACHE[key]
        if resolved is None:
            LOG.error("No handler %s on %s", name, cls.__name__)
            return None
        try:
            return getattr(n, resolved)(*args)
        except Exception as e:  # noqa: BLE001 — framework boundary
            if not handle_exceptions:
                raise
            # Route to the root's throwable catcher (the engine's hook).
            root: Node = self
            while root._parent is not None:
                root = root._parent
            cfg = root._config
            if cfg is not None and cfg.log_exceptions:
                LOG.exception("Error invoking %s on %s", name, cls.__name__)
            if cfg is not None and cfg.throwable_catcher is not None:
                cfg.throwable_catcher(e)
            return None

    # ------------------------------------------------------------ configuring

    def config(self, cfg: NodeConfig) -> None:
        """Wire engine hooks into this (root) node (Node.java:582-601)."""
        if self._parent is not None:
            LOG.error("Cannot configure node already configured as sub-node")
        if cfg.message_adder is None and cfg.batch_message_adder is None:
            LOG.error("Config must include a message adder")
        self._config = cfg

    @property
    def configured(self) -> bool:
        return self._config is not None
