"""ClientWorker: the workload-driving wrapper node around a student Client.

Re-design of framework/tst/.../ClientWorker.java:53-310.  The worker *is* a
Node at the client's address; it interposes on the framework delivery entry
points, forwards them to the wrapped client node, and after every delivery
pumps ``send_next_command_while_possible``: collect an available result, check
it against the workload's expected result, and send the next command.

Critical semantics (SURVEY §7.8): **equality and hashing cover only
(client, results)** so that search states differing merely in bookkeeping
(sent-command lists, waiting flags) hash identically
(ClientWorker.java:49-52).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.node import Node, NodeConfig
from dslabs_tpu_torch.core.types import Client, Command, Message, Result, Timer
from dslabs_tpu_torch.testing.workload import Workload
from dslabs_tpu_torch.utils.structural import clone

__all__ = ["ClientWorker", "InterRequestTimer"]


@dataclass(frozen=True)
class InterRequestTimer(Timer):
    """Private rate-limiting timer (ClientWorker.java:55)."""


class ClientWorker(Node):

    __deepcopy_skip__ = ("_config", "_sync", "_last_send_time", "_max_wait")

    def __init__(self, client, workload: Workload,
                 record_commands_and_results: bool = True):
        assert isinstance(client, Node) and isinstance(client, Client)
        super().__init__(client.address)
        self.client = client
        self.results: List[Result] = []
        # Clone the workload on creation to avoid sharing across workers
        # (ClientWorker.java:94-96).
        self._workload: Workload = clone(workload)
        self._workload.reset()
        self._record = record_commands_and_results
        self._initialized = False
        self._waiting_on_result = False
        self._waiting_to_send = False
        self._last_command: Optional[Command] = None
        self._expected_result: Optional[Result] = None
        self._sent_commands: List[Command] = []
        self._results_ok = True
        self._expected_and_received: Optional[Tuple[Result, Result]] = None
        self._last_send_time: Optional[float] = None
        self._max_wait: Optional[Tuple[float, float]] = None  # (duration_s, send_time)
        self._sync: Optional[threading.Condition] = None

    # Equality = (client, results) ONLY (ClientWorker.java:49-52).
    def _eq_fields(self):
        return {"client": self.client, "results": self.results}

    # ------------------------------------------------------------- threading

    def _cond(self) -> threading.Condition:
        if self._sync is None:
            self._sync = threading.Condition()
        return self._sync

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_sync"] = None
        d["_config"] = None
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)

    # ------------------------------------------------------------ properties

    @property
    def workload(self) -> Workload:
        return self._workload

    @property
    def sent_commands(self) -> List[Command]:
        return self._sent_commands

    @property
    def record_commands_and_results(self) -> bool:
        return self._record

    def results_ok(self) -> Tuple[bool, Optional[str]]:
        if self._results_ok:
            return True, None
        exp, got = self._expected_and_received
        return False, f"expected {exp!r}, received {got!r}"

    @property
    def expected_and_received(self):
        return self._expected_and_received

    def add_command(self, command, result=None) -> None:
        with self._cond():
            self._workload.add(command, result)
            self._pump()

    # ------------------------------------------------------------- wait stats

    def max_wait(self, stop_time: Optional[float] = None) -> Optional[Tuple[float, float]]:
        """Longest observed wait (seconds) and the send time it corresponds
        to; includes the currently outstanding command up to ``stop_time``
        (ClientWorker.java:144-172)."""
        with self._cond():
            return self._max_wait_internal(stop_time if stop_time is not None
                                           else time.monotonic())

    def _max_wait_internal(self, ref: float):
        if not self._waiting_on_result or self._last_send_time is None:
            return self._max_wait
        current = ref - self._last_send_time
        if self._max_wait is not None and self._max_wait[0] >= current:
            return self._max_wait
        return (current, self._last_send_time)

    # ------------------------------------------------------------- the pump

    def _pump(self) -> None:
        """sendNextCommandWhilePossible (ClientWorker.java:174-235)."""
        if not self._initialized:
            return
        while True:
            if self._waiting_on_result and self.client.has_result():
                result = self.client.get_result()
                self._max_wait = self._max_wait_internal(time.monotonic())
                if self._record:
                    self._sent_commands.append(self._last_command)
                    self.results.append(result)
                if self._workload.has_results() and self._expected_result != result:
                    self._results_ok = False
                    if self._expected_and_received is None:
                        self._expected_and_received = (self._expected_result, result)
                self._waiting_on_result = False
                self._last_command = None
                self._expected_result = None

            if (self._waiting_on_result or self._waiting_to_send
                    or not self._workload.has_next()):
                break

            if self._workload.millis_between_requests > 0:
                self.set_timer(InterRequestTimer(),
                               self._workload.millis_between_requests)
                self._waiting_to_send = True
                break

            self._send_next_command()

        if self.done():
            self._cond().notify_all()

    def _send_next_command(self) -> None:
        if self._workload.has_results():
            cmd, res = self._workload.next_command_and_result(self.client.address)
            self._last_command, self._expected_result = cmd, res
        else:
            self._last_command = self._workload.next_command(self.client.address)
        self.client.send_command(self._last_command)
        self._waiting_to_send = False
        self._waiting_on_result = True
        self._last_send_time = time.monotonic()

    def done(self) -> bool:
        return not self._waiting_on_result and not self._workload.has_next()

    def wait_until_done(self, timeout_s: Optional[float] = None) -> None:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond():
            while not self.done():
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return
                self._cond().wait(remaining)

    # --------------------------------------------------- Node entry overrides

    def init(self) -> None:
        with self._cond():
            self._initialized = True
            self.client.init()
            self._pump()

    def deliver_message(self, message: Message, sender: Address,
                        destination: Optional[Address] = None) -> None:
        with self._cond():
            self.client.deliver_message(message, sender, destination)
            self._pump()

    def deliver_timer(self, timer: Timer,
                      destination: Optional[Address] = None) -> None:
        with self._cond():
            if isinstance(timer, InterRequestTimer):
                self._send_next_command()
            else:
                self.client.deliver_timer(timer, destination)
            self._pump()

    def config(self, cfg: NodeConfig) -> None:
        # Both the worker (for InterRequestTimer) and the wrapped client share
        # the engine hooks (ClientWorker.java:293-309).
        super().config(cfg)
        self.client.config(cfg)
