"""The launch census and the taint pass of the contract checks (DESIGN.md
§13), after ``repro.analysis.walker``.

The JAX auditor walks a traced jaxpr.  The port runs each audited program
once, eagerly, under a recorder (``contracts.record``), and these are the
passes that watch the run:

  * ``LaunchLog``, the census: every call of a kernel wrapper reports its
    launch through the hook of ``kernels.common.kernel_wrapper``, with the
    name of the CUDA kernel it launches (on the CPU the plain version
    stands for the launch, as interpret mode stands for a ``pallas_call``).
    Only the port's own kernels are counted: threefry's elementwise torch
    ops and the other torch calls around the kernels are not kernels of the
    port (ROADMAP Queue C item 8), so counting every CUDA launch would fail
    ``step == 1`` by construction.
  * ``Taint``, the ancestors-through-device-memory round trip: a
    ``TorchFunctionMode`` whose taint starts at the integer outputs of a
    kernel wrapper (the ancestors), spreads through every op whose output
    is an integer tensor and whose inputs include a tainted one, and whose
    finding is a gather or scatter with a tainted *index*: the ancestors
    leaving a kernel and coming back as gather indices, which the fused
    apply and step remove (DESIGN.md §11).  Inside a wrapper nothing is
    checked or spread: a plain version's gather is the kernel's own work,
    as JAX's walker does not flag the inside of a ``pallas_call``; a tainted
    index handed to a second wrapper is an argument, not a gather.
    Constant indices are never flagged: taint starts only at kernel outputs.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.kernels.common import inside_kernel_wrapper

#: Gathers and scatters by name, with the position of their index operand
#: (``self`` counted, so a method and its function share it):
#: ``Tensor.__getitem__``/``__setitem__`` with a tensor index,
#: ``index_select``, ``gather``, ``take``, ``take_along_dim``, ``index_put``
#: and the ``scatter`` and ``index_*`` families.
INDEX_OPERAND = {
    "__getitem__": 1, "__setitem__": 1, "index_put": 1, "index_put_": 1, "take": 1,
    "take_along_dim": 1, "put": 1, "put_": 1,
    "index_select": 2, "gather": 2, "scatter": 2, "scatter_": 2, "scatter_add": 2,
    "scatter_add_": 2, "scatter_reduce": 2, "scatter_reduce_": 2, "index_add": 2,
    "index_add_": 2, "index_copy": 2, "index_copy_": 2, "index_fill": 2, "index_fill_": 2,
}
_PORT = Path(__file__).resolve().parent.parent
#: Frames that are not the audited program's: torch's, the recorders' own
#: and ``random.py``'s (``uniform`` reaching ``random_bits``).
_SKIP = (str(Path(torch.__file__).resolve().parent), str(_PORT / "random.py"),
         str(Path(__file__).resolve()), str(Path(__file__).resolve().parent / "rng.py"))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from a pass; ``code`` is the machine-readable id the
    contract table and the waiver list key on."""

    pass_name: str
    code: str
    where: str
    detail: str

    def as_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        return f"[{self.pass_name}:{self.code}] {self.where or '<top>'}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a recorded run: the kernel, the wrapper that
    launched it and the rows and length of its first tensor argument (or of
    its output, for a wrapper that takes none)."""

    kernel: str
    wrapper: str
    rows: int
    n: int


def program_stack() -> tuple:
    """The call stack of the audited program at this point, innermost first,
    as ``("path:line", bytecode offset)`` pairs (``_SKIP``'s frames left
    out): two calls on one line differ by their offsets, one call run again
    in a loop does not."""
    sites = []
    frame = sys._getframe(1)
    while frame is not None:
        path = str(Path(frame.f_code.co_filename).resolve())
        if not path.startswith(_SKIP):
            rel = path[len(str(_PORT.parent)) + 1:] if path.startswith(str(_PORT)) else \
                Path(path).name
            sites.append((f"{rel}:{frame.f_lineno}", frame.f_lasti))
        frame = frame.f_back
    return tuple(sites)


def tensors(obj):
    """The tensors in ``obj``: a tensor, or tuples, lists and dicts of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors(x)


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool)


class Taint(TorchFunctionMode):
    """The taint pass: ``mark`` the integer outputs of a kernel; the mode
    spreads the taint and collects ``findings``."""

    def __init__(self):
        super().__init__()
        self._tainted: dict = {}  # id -> tensor, held so that no id is reused
        self.findings: list = []

    def mark(self, out):
        for t in tensors(out):
            if _is_int(t):
                self._tainted[id(t)] = t

    def _hit(self, obj) -> bool:
        return any(id(t) in self._tainted for t in tensors(obj))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._tainted or inside_kernel_wrapper():
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        pos = INDEX_OPERAND.get(name)
        if pos is not None:
            index = kwargs.get("index", kwargs.get("indices", args[pos:pos + 1]))
            if self._hit(index):
                self.findings.append(Finding(
                    "census", "ancestor-roundtrip", program_stack()[0][0],
                    f"{name} indexes device memory with indices derived from a kernel's "
                    "output (ancestor round-trip)"))
        out = func(*args, **kwargs)
        if self._hit((args, kwargs)):
            self.mark(out)
        return out


class LaunchLog:
    """The launch observer of one recorded run: ``launches`` in order; with
    ``taint`` each kernel's integer outputs become taint sources."""

    def __init__(self, taint: Taint | None = None):
        self.launches: list = []
        self._taint = taint

    def launched(self, kernel, wrapper, args, out):
        first = next(tensors(args), None)
        shape = tuple((first if first is not None else next(tensors(out))).shape) or (1,)
        rows = 1
        for s in shape[:-1]:
            rows *= s
        self.launches.append(Launch(kernel, wrapper, rows, shape[-1]))
        if self._taint is not None:
            self._taint.mark(out)


def launch_census(launches) -> collections.Counter:
    """Launches by kernel name."""
    return collections.Counter(launch.kernel for launch in launches)


def count_launches(launches) -> int:
    """Number of the port's kernel launches in a recorded run (eagerly: a
    launch in a loop counts once per pass)."""
    return len(launches)
