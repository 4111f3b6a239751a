"""The repo's lab test files (``tests/test_lab*.py``) as modules of this
package, unedited on disk.

Importing ``dslabs_tpu_torch._labtests.<name>`` reads ``tests/<name>.py``,
rewrites the import root ``dslabs_tpu.`` to ``dslabs_tpu_torch.`` and
executes the result as that module, so its ``lab_test`` entries land in
this package's registry (``harness.annotations``) and its searches run
through this package.  Only this namespace is served: ``dslabs_tpu`` is
never aliased or imported.  Importing this package installs the finder,
so a saved trace that names a lab test module resolves in a fresh process
too.
"""

from __future__ import annotations

import importlib.abc
import importlib.util
import os
import sys

TESTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests")


def rewrite(source: str) -> str:
    """The lab file's source with its imports moved to this package."""
    return source.replace("dslabs_tpu.", "dslabs_tpu_torch.")


class _Loader(importlib.abc.Loader):

    def __init__(self, path: str):
        self.path = path

    def create_module(self, spec):
        return None

    def get_source(self, fullname: str) -> str:
        with open(self.path, encoding="utf-8") as f:
            return rewrite(f.read())

    def exec_module(self, module) -> None:
        code = compile(self.get_source(module.__name__), self.path, "exec")
        exec(code, module.__dict__)


class _Finder(importlib.abc.MetaPathFinder):

    def find_spec(self, fullname, path=None, target=None):
        prefix = __name__ + "."
        if not fullname.startswith(prefix):
            return None
        name = fullname[len(prefix):]
        file = os.path.join(TESTS_DIR, name + ".py")
        if "." in name or not os.path.isfile(file):
            return None
        return importlib.util.spec_from_file_location(
            fullname, file, loader=_Loader(file))


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _Finder())
