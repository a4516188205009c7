"""A dispatch guard against host reads of device data, for the port's tests.

A program that is captured into a CUDA graph (the device epoch, the decode
step) must never read the device on the host: every op that synchronises on
CUDA -- a tensor's value turned into a Python number, a data-dependent
output size, a boolean-mask index -- fails at capture on the card.  The CPU
tests cannot capture, so :class:`NoHostReads` fails on those ops by name as
they dispatch, on any device, and every tier-1 run checks what would
otherwise fail only on the card.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: Ops whose output size, or whose result, is a value the host must read.
_SYNCING = {"_local_scalar_dense", "nonzero", "masked_select", "bincount"}
_INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class HostRead(AssertionError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raise :class:`HostRead` on ``aten._local_scalar_dense`` (``int()``,
    ``.item()``, ``bool()`` of a tensor), ``aten.nonzero``,
    ``aten.masked_select``, ``aten.bincount``, ``aten.unique*``,
    ``aten.repeat_interleave`` without ``output_size``, and ``aten.index``
    or ``aten.index_put_`` with a boolean index.  ``seen`` counts every op
    that went through, by name."""

    def __init__(self):
        super().__init__()
        self.seen: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.seen[name] = self.seen.get(name, 0) + 1
        bad = name in _SYNCING or "unique" in name
        if name == "repeat_interleave" and kwargs.get("output_size") is None and (
            len(args) < 3 or args[-1] is None
        ):
            bad = True
        if name in _INDEXING and len(args) > 1:
            bad = bad or any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in (args[1] or ())
            )
        if bad:
            raise HostRead(f"{func} reads the device on the host")
        return func(*args, **kwargs)
