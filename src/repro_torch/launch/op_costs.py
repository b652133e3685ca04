"""What one rank's step does, counted while it runs: FLOPs, collectives, memory.

Counterpart of ``repro/launch/hlo_costs.py``.  The reference parses the
compiled, partitioned HLO text of a step; the port has no compiled
program, so ``OpCosts`` counts the step as it runs, usually on ``meta``
tensors under a fake process group (``launch/dryrun.py``), where nothing
is allocated and every collective returns at once:

* matmul and attention FLOPs, through ``torch.utils.flop_counter
  .FlopCounterMode`` (2 * m * n * k a product, as the reference counts a
  ``dot``);
* each collective's calls and bytes, by kind (``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``broadcast``, ``all_to_all``).
  They are counted by a ``TorchDispatchMode`` over the ``c10d`` operators:
  every ``torch.distributed`` collective -- the port's wrappers in
  ``models/parallel.py``, ``launch/train.py``'s payload and stats
  ``all_reduce``s, ``gather_tree``, ``broadcast_object_list`` -- reaches
  the process group through one of these operators, so the mode sees
  every call whatever Python function made it.  The bytes are the
  operator's output tensors (an in-place collective's tensors), as the
  reference sums its collectives' output shapes;
* memory on the ``meta`` device: a dispatch mode adds each new storage's
  bytes when an operator returns it and drops them when the storage is
  freed (a weak reference's callback), so ``peak_bytes`` is the most the
  rank held at once.  The arguments are the storages named at entry, the
  outputs those named by ``set_outputs`` that are not arguments, and the
  temporaries what the peak held beyond both, as the reference's
  ``memory_analysis`` splits them;
* the hand-written kernels, which cannot run on ``meta``:
  ``kernels/ops.py``'s meta route returns an empty output and calls
  ``record_kernel`` with the bytes its bound counts.

The Python loop is the trip count here: a loop over layers, chunks or
local steps runs every iteration, so nothing is weighted as the
reference weights a ``while`` body by its trip count.
"""

from __future__ import annotations

import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

COLL_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
              "all_to_all")

# c10d operator name -> kind; the first argument of each is its output
_C10D = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "broadcast_": "broadcast",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
}

_ACTIVE: list["OpCosts"] = []


def record_kernel(name: str, nbytes: float) -> None:
    """One launch of a hand-written kernel and the bytes it moves, into the
    innermost ``OpCosts`` entered (none: nothing to record)."""
    if _ACTIVE:
        k = _ACTIVE[-1].kernels.setdefault(name, {"launches": 0, "bytes": 0.0})
        k["launches"] += 1
        k["bytes"] += float(nbytes)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Mode(TorchDispatchMode):
    def __init__(self, owner: "OpCosts"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            kind = _C10D.get(func._opname)
            if kind is not None:
                self.owner._collective(kind, args[0] if args else ())
        else:
            self.owner._track(out)
        return out


class OpCosts:
    """Counts one rank's step.  ``args`` (any tree of tensors) are the step's
    arguments, already held; the memory counted is the ``meta`` device's.
    Use as a context manager, call ``set_outputs`` with what the step
    returned, then read ``counts()``."""

    def __init__(self, args: Any = None):
        self.flops = FlopCounterMode(display=False)
        self.calls = {k: 0 for k in COLL_KINDS}
        self.bytes = {k: 0 for k in COLL_KINDS}
        self.kernels: dict[str, dict] = {}
        self._live: dict[int, tuple[int, weakref.ref]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = self._track(args)
        self._args = set(self._live)
        self.output_bytes = 0

    # -- memory --
    def _track(self, tree) -> int:
        """Add the storages of ``tree``'s ``meta`` tensors not yet live;
        returns the bytes added."""
        added = 0
        for x in _tensors(tree):
            if x.device.type != "meta":
                continue
            st = x.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.ref(st, self._freed(key)))
            added += n
        if added:
            self.live_bytes += added
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    def _freed(self, key: int):
        def cb(_ref):
            entry = self._live.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[0]
        return cb

    def set_outputs(self, tree) -> None:
        """The step's outputs: their storages that are not arguments."""
        seen = set()
        total = 0
        for x in _tensors(tree):
            if x.device.type != "meta":
                continue
            key = x.untyped_storage()._cdata
            if key in self._args or key in seen:
                continue
            seen.add(key)
            total += x.untyped_storage().nbytes()
        self.output_bytes = total

    # -- collectives --
    def _collective(self, kind: str, out) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += sum(x.numel() * x.element_size() for x in _tensors(out))

    def __enter__(self):
        _ACTIVE.append(self)
        self.flops.__enter__()
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self.flops.__exit__(*exc)
        _ACTIVE.remove(self)
        return False

    def counts(self) -> dict:
        temp = max(self.peak_bytes - self.argument_bytes - self.output_bytes, 0)
        return {
            "flops": int(self.flops.get_total_flops()),
            "collective_calls": dict(self.calls),
            "collective_bytes": dict(self.bytes),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "memory": {"argument_bytes": self.argument_bytes,
                       "output_bytes": self.output_bytes,
                       "temp_bytes": temp, "peak_bytes": self.peak_bytes},
        }
