"""Primitive calls and the host syncs each takes on the card: the rules of
the hot-path audit's J1 count (:mod:`.hotpath_audit`) as a table.

Each case is ``fn(x)`` over ``x = torch.arange(16)`` on the device under
test, with the synchronising CUDA calls one call makes on an H100 under
``torch.cuda.set_sync_debug_mode("warn")`` (torch 2.11).  Shared by
``tests/test_torch_hotpath_audit.py`` (the audit's count on the CPU
equals the table) and ``chip_smoke.py``'s analysis phase (on the card the
table, the sync debug mode's count and the audit's counts on the card and
on the CPU are equal).  Uploads of host data sync like readbacks; an
empty transfer does not; ``nonzero`` of an empty tensor does; a
boolean-mask store of a scalar is a masked fill; ``repeat_interleave`` by
a tensor reads back twice."""

import numpy as np
import torch


def _dev(x):
    return x.device


CASES = {
    "item": (lambda x: x.sum().item(), 1),
    "int": (lambda x: int(x[3]), 1),
    "bool": (lambda x: bool((x > 3).any()), 1),
    "tolist": (lambda x: x.tolist(), 1),
    "cpu": (lambda x: x.cpu(), 1),
    "to_cpu_copy": (lambda x: x.to("cpu", copy=True), 1),
    "readback_empty": (lambda x: x[:0].cpu(), 0),
    "upload_scalar": (lambda x: torch.as_tensor(5, device=_dev(x)), 1),
    "upload_numpy": (lambda x: torch.as_tensor(np.arange(3),
                                               device=_dev(x)), 1),
    "upload_list": (lambda x: torch.tensor([1, 2], device=_dev(x)), 1),
    "from_numpy_to_device": (
        lambda x: torch.from_numpy(np.arange(3)).to(_dev(x)), 1),
    "upload_empty": (
        lambda x: torch.from_numpy(np.zeros((0,), np.int64)).to(_dev(x)),
        0),
    "host_tensor_to_device": (lambda x: torch.arange(4).to(_dev(x)), 1),
    "device_to_device": (lambda x: x.to(_dev(x)), 0),
    "nonzero": (lambda x: torch.nonzero(x > 7), 1),
    "nonzero_empty": (lambda x: torch.nonzero(x[:0]), 1),
    "bool_mask_read": (lambda x: x[x > 7], 1),
    "bool_mask_store_scalar": (
        lambda x: x.clone().__setitem__(x > 7, 0), 0),
    "list_index": (lambda x: x[[0, 1]], 1),
    "host_tensor_index": (lambda x: x[torch.arange(2)], 1),
    "device_tensor_index": (
        lambda x: x[torch.arange(2, device=_dev(x))], 0),
    "store_host_value": (
        lambda x: x.clone().__setitem__(slice(0, 3), torch.arange(3)), 1),
    "copy_from_host": (lambda x: x[:4].clone().copy_(torch.arange(4)), 1),
    "repeat_interleave_tensor": (
        lambda x: torch.repeat_interleave(x.clamp(max=2)), 2),
    "repeat_interleave_int": (lambda x: x.repeat_interleave(3), 0),
    "masked_select": (lambda x: torch.masked_select(x, x > 7), 1),
    "unique": (lambda x: torch.unique(x), 1),
    "where_one_arg": (lambda x: torch.where(x > 7), 1),
    "device_ops": (lambda x: torch.where(x > 3, x, 0).sum()
                   + torch.full_like(x, 3).max(), 0),
    "host_only_work": (
        lambda x: torch.cat([torch.tensor([1]), torch.tensor([2])]).numpy(),
        0),
}


def operand(device) -> torch.Tensor:
    return torch.arange(16, device=device)
