"""Test registry + annotations — the @Lab/@Part/@TestDescription/
@TestPointValue/@Category system (junit/Lab.java:35, Part.java:33,
TestDescription.java:32, TestPointValue.java:32, RunTests.java:25,
SearchTests.java:25, UnreliableTests.java:25) re-designed as one function
decorator.

A lab test is an ordinary pytest function decorated with
:func:`lab_test`; the decorator registers it (module import populates the
registry, like the reference's classpath scan in utils/ClassSearch.java:35)
and leaves the function itself untouched, so the same test runs under
pytest and under the CLI driver (`run_tests.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

__all__ = ["RUN_TESTS", "SEARCH_TESTS", "UNRELIABLE_TESTS", "TestEntry",
           "lab_test", "registry", "clear_registry"]

# Category markers (reference: JUnit @Category classes).
RUN_TESTS = "RunTests"
SEARCH_TESTS = "SearchTests"
UNRELIABLE_TESTS = "UnreliableTests"


@dataclasses.dataclass(frozen=True)
class TestEntry:
    __test__ = False          # not itself a pytest collectable

    fn: Callable
    lab: str                       # "0".."4" (string, like @Lab)
    num: int                       # test number (test01Foo -> 1)
    description: str
    points: int = 0
    part: Optional[int] = None
    categories: Tuple[str, ...] = ()
    timeout_secs: Optional[float] = None

    @property
    def full_number(self) -> str:
        """DSLabsTestCore's part-qualified number ("2.1" / "7")."""
        if self.part is not None:
            return f"{self.part}.{self.num}"
        return str(self.num)

    @property
    def name(self) -> str:
        return self.fn.__name__

    def sort_key(self):
        return (self.lab, self.part or 0, self.num, self.name)


_REGISTRY: List[TestEntry] = []


def lab_test(lab: str, num: int, description: str, points: int = 0,
             part: Optional[int] = None,
             categories: Tuple[str, ...] = (RUN_TESTS,),
             timeout_secs: Optional[float] = None):
    """Register a lab test with its reference metadata.

    Numbers, descriptions, and point values mirror the reference lab test
    suites (cited per test at the use sites), so `run_tests.py --lab N`
    reproduces the reference's selection and scoring shape."""

    def deco(fn):
        entry = TestEntry(fn=fn, lab=str(lab), num=num,
                          description=description, points=points, part=part,
                          categories=tuple(categories),
                          timeout_secs=timeout_secs)
        _REGISTRY.append(entry)
        fn._dslabs_test_entry = entry
        return fn

    return deco


def registry() -> List[TestEntry]:
    return sorted(_REGISTRY, key=TestEntry.sort_key)


def clear_registry() -> None:
    _REGISTRY.clear()
