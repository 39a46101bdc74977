"""Shared memory, registers and co-residency of every launch (DESIGN.md §13,
pass 4), the H100's counterpart of ``repro.analysis.vmem``.

The TPU pass prices each ``pallas_call``'s VMEM-resident blocks against
``MAX_VMEM_*``.  On the card a launch is limited by what one block may hold
(shared memory, registers) and, for a cooperative launch, by how many blocks
can be co-resident, because its grid barriers need the whole grid on the
card at once: that grid is sized to the co-resident count, so it holds
when the count is right, and the card's occupancy query checks the count
(``card_drift``).  This pass prices each launch of a recorded run from
``KERNELS``, the port's per-kernel resource table, and the launch's rows and
length (the step kernels' dynamic shared memory holds 8 bytes per row;
their grid, and the scan's, is as many blocks as can be co-resident, no more
than the work needs, as ``coop_step_grid`` and ``prefix_scan_grid`` size
it), and checks it against the card's limits (``CARD_LIMITS``).  Pricing
needs no launch, so the largest shapes the wrappers admit are priced too
(``large_n_footprints``), and so is a declared launch that must never run
(the ``oversized_vmem`` fixture).

``KERNELS`` and ``CARD_LIMITS`` are of an NVIDIA H100 80GB HBM3 at 700 W,
the registers and static shared memory as ``ptxas`` built them for sm_90a
and the runtime reports them (``cudaFuncGetAttributes``); ``chip_smoke.py``
reads the card's own numbers (``card_attributes``, ``card_limits``) and
fails on any drift from these.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

from repro_torch.analysis.walker import Finding
from repro_torch.kernels.common import MAX_PARTICLES, MAX_ROWS, MAX_STEP_ROWS

#: Threads per block of every kernel of the port (``NT`` in ``common.cuh``).
NT = 256
WARP = 32
#: The card's limits (NVIDIA H100 80GB HBM3, 700 W; ``cudaDeviceGetAttribute``
#: on the card, checked by ``chip_smoke.py``), in ``fixtures_device_limits``'
#: order.
CARD_LIMITS = {
    "smem_per_block_optin": 232448,     # 227 KiB, above 48 KiB after an opt-in
    "smem_per_block": 49152,            # 48 KiB without the opt-in
    "smem_per_sm": 233472,              # 228 KiB
    "smem_reserved_per_block": 1024,
    "regs_per_sm": 65536,
    "threads_per_sm": 2048,
    "blocks_per_sm": 32,
    "sms": 132,
}
#: Registers a thread may hold (sm_90; no device attribute reports it).
REGS_PER_THREAD = 255
#: Allocation units of the occupancy rule: registers per warp, shared memory.
REG_ALLOC_UNIT = 256
SMEM_ALLOC_UNIT = 128
#: Rows of index arithmetic a bank launch admits: ``S·N < 2**31``.
MAX_ELEMENTS = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One kernel's row of the resource table: its source, its position in
    the source's ``<stem>_attributes``, registers per thread, static shared
    memory, dynamic shared memory per row of a launch, and its grid:
    ``rows`` (``ceil(N / NT)`` by S), ``tiles`` (``N / 1024`` by S),
    ``resident`` (co-resident, at most ``ceil(N / (4·NT))``: one 16-byte
    vector a thread), ``row`` (one block a row, of ``threads``), or
    cooperative ``coop_step`` and ``coop_search`` (co-resident, at most
    ``ceil(S·N / NT)``; a search admits ``MAX_ROWS`` rows) and ``coop_scan``
    (co-resident, at most ``S·N / 1024``).  ``optin``: the kernel raises its dynamic
    shared memory limit (``cudaFuncAttributeMaxDynamicSharedMemorySize``)
    where a launch needs more than 48 KiB in all, so its budget is the
    opt-in limit.  ``threads``: threads a block (``NT`` but for the row
    reduction's)."""

    source: str
    index: int
    registers: int
    static_smem: int
    grid: str
    smem_per_row: int = 0
    smem_per_element: int = 0
    optin: bool = False
    threads: int = NT

    @property
    def cooperative(self) -> bool:
        return self.grid.startswith("coop")


def _rows(source, index, regs, smem, grid="rows"):
    return KernelResources(source, index, regs, smem, grid)


def _step(source, index, regs, smem, optin=False):
    return KernelResources(source, index, regs, smem, "coop_step", smem_per_row=8, optin=optin)


_MEGO, _METRO, _C1C2 = ("megopolis/csrc/megopolis.cu", "metropolis/csrc/metropolis.cu",
                        "metropolis/csrc/c1c2.cu")
_REJ, _PREFIX, _FIX = ("rejection/csrc/rejection.cu", "prefix_sum/csrc/prefix_sum.cu",
                       "fixtures/csrc/fixtures.cu")
_REDUCE = "reduce/csrc/reduce.cu"
#: Every kernel instance of the port, by the name the profiler gives it.
KERNELS = {
    # The Megopolis kernels' static shared memory is their ring of
    # comparison segments (4 KiB and 16 bytes each at float32 words, 2 KiB
    # and 16 bytes at 2-byte words; three for the bank kernel, four for the
    # step) and the per-chunk table; the bank kernel runs a block per 1024
    # particles ("tiles").  The Megopolis and Metropolis kernels have an
    # instance per plane word (float, __nv_bfloat16, __half).
    "megopolis_fused_rows_kernel<false, float>": _rows(_MEGO, 0, 32, 14464, "tiles"),
    "megopolis_fused_rows_kernel<true, float>": _rows(_MEGO, 1, 32, 14464, "tiles"),
    "megopolis_step_rows_kernel<float>": _step(_MEGO, 2, 32, 18816, optin=True),
    "megopolis_fused_rows_kernel<false, __nv_bfloat16>": _rows(_MEGO, 3, 32, 8320, "tiles"),
    "megopolis_fused_rows_kernel<true, __nv_bfloat16>": _rows(_MEGO, 4, 32, 8320, "tiles"),
    "megopolis_step_rows_kernel<__nv_bfloat16>": _step(_MEGO, 5, 32, 10624, optin=True),
    "megopolis_fused_rows_kernel<false, __half>": _rows(_MEGO, 6, 32, 8320, "tiles"),
    "megopolis_fused_rows_kernel<true, __half>": _rows(_MEGO, 7, 32, 8320, "tiles"),
    "megopolis_step_rows_kernel<__half>": _step(_MEGO, 8, 32, 10624, optin=True),
    "metropolis_rows_kernel<false, float>": _rows(_METRO, 0, 32, 1024),
    "metropolis_rows_kernel<true, float>": _rows(_METRO, 1, 40, 1024),
    "metropolis_step_rows_kernel<float>": _step(_METRO, 2, 32, 32),
    "metropolis_rows_kernel<false, __nv_bfloat16>": _rows(_METRO, 3, 32, 1024),
    "metropolis_rows_kernel<true, __nv_bfloat16>": _rows(_METRO, 4, 34, 1024),
    "metropolis_step_rows_kernel<__nv_bfloat16>": _step(_METRO, 5, 32, 32),
    "metropolis_rows_kernel<false, __half>": _rows(_METRO, 6, 32, 1024),
    "metropolis_rows_kernel<true, __half>": _rows(_METRO, 7, 34, 1024),
    "metropolis_step_rows_kernel<__half>": _step(_METRO, 8, 32, 32),
    # The C1/C2 kernels' static shared memory is their partition tiles (one
    # for C1; C2's ring of five buffers of two in the bank kernel, three of
    # two in the step; 4 KiB a tile at float32 words, 2 KiB at 2-byte
    # words) with the per-chunk table of hash prefixes and C2's tiles; C2's
    # step opts in above 48 KiB.  From here on every kernel has an instance
    # per plane word too (rejection's and the prefix-sum kernels': the
    # index-only searches read no plane, and have the float one alone).
    "metropolis_c1c2_rows_kernel<1, false, float>": _rows(_C1C2, 0, 32, 6272, "tiles"),
    "metropolis_c1c2_rows_kernel<1, true, float>": _rows(_C1C2, 1, 40, 6272, "tiles"),
    "metropolis_c1c2_rows_kernel<2, false, float>": _rows(_C1C2, 2, 47, 43136, "tiles"),
    "metropolis_c1c2_rows_kernel<2, true, float>": _rows(_C1C2, 3, 48, 43136, "tiles"),
    "metropolis_c1c2_step_rows_kernel<1, float>": _step(_C1C2, 4, 57, 6400),
    "metropolis_c1c2_step_rows_kernel<2, float>": _step(_C1C2, 5, 64, 26880, optin=True),
    "metropolis_c1c2_rows_kernel<1, false, __nv_bfloat16>": _rows(_C1C2, 6, 32, 4224, "tiles"),
    "metropolis_c1c2_rows_kernel<1, true, __nv_bfloat16>": _rows(_C1C2, 7, 40, 4224, "tiles"),
    "metropolis_c1c2_rows_kernel<2, false, __nv_bfloat16>": _rows(_C1C2, 8, 42, 22656, "tiles"),
    "metropolis_c1c2_rows_kernel<2, true, __nv_bfloat16>": _rows(_C1C2, 9, 48, 22656, "tiles"),
    "metropolis_c1c2_step_rows_kernel<1, __nv_bfloat16>": _step(_C1C2, 10, 62, 4352),
    "metropolis_c1c2_step_rows_kernel<2, __nv_bfloat16>": _step(_C1C2, 11, 64, 14592,
                                                               optin=True),
    "metropolis_c1c2_rows_kernel<1, false, __half>": _rows(_C1C2, 12, 32, 4224, "tiles"),
    "metropolis_c1c2_rows_kernel<1, true, __half>": _rows(_C1C2, 13, 40, 4224, "tiles"),
    "metropolis_c1c2_rows_kernel<2, false, __half>": _rows(_C1C2, 14, 42, 22656, "tiles"),
    "metropolis_c1c2_rows_kernel<2, true, __half>": _rows(_C1C2, 15, 48, 22656, "tiles"),
    "metropolis_c1c2_step_rows_kernel<1, __half>": _step(_C1C2, 16, 62, 4352),
    "metropolis_c1c2_step_rows_kernel<2, __half>": _step(_C1C2, 17, 64, 14592, optin=True),
    # The rejection step's registers are capped at 48 (5 blocks an SM).
    "rejection_rows_kernel<false, float>": _rows(_REJ, 0, 31, 1024),
    "rejection_rows_kernel<true, float>": _rows(_REJ, 1, 32, 1024),
    "rejection_step_rows_kernel<float>": _step(_REJ, 2, 48, 32),
    "rejection_rows_kernel<false, __nv_bfloat16>": _rows(_REJ, 3, 32, 1024),
    "rejection_rows_kernel<true, __nv_bfloat16>": _rows(_REJ, 4, 32, 1024),
    "rejection_step_rows_kernel<__nv_bfloat16>": _step(_REJ, 5, 48, 32),
    "rejection_rows_kernel<false, __half>": _rows(_REJ, 6, 32, 1024),
    "rejection_rows_kernel<true, __half>": _rows(_REJ, 7, 32, 1024),
    "rejection_step_rows_kernel<__half>": _step(_REJ, 8, 48, 32),
    # The prefix-sum scan of an input word; the searches of rising draws, a
    # thread a slot; of the others, one cooperative launch that writes the
    # rows' trees, then searches; each copying state words.
    "prefix_scan_rows_kernel<float>": _rows(_PREFIX, 0, 32, 4688, "coop_scan"),
    "prefix_search_rows_kernel<false, float>": _rows(_PREFIX, 1, 16, 0),
    "prefix_search_rows_kernel<true, float>": _rows(_PREFIX, 2, 31, 0),
    "prefix_search_tree_kernel<false, false, float>": _rows(_PREFIX, 3, 32, 0, "coop_search"),
    "prefix_search_tree_kernel<true, false, float>": _rows(_PREFIX, 4, 32, 0, "coop_search"),
    "prefix_search_tree_kernel<true, true, float>": _rows(_PREFIX, 5, 32, 0, "coop_search"),
    "prefix_step_rows_kernel<0, float>": _step(_PREFIX, 6, 63, 4720),
    "prefix_step_rows_kernel<1, float>": _step(_PREFIX, 7, 40, 4720),
    "prefix_step_rows_kernel<2, float>": _step(_PREFIX, 8, 40, 4720),
    "prefix_step_rows_kernel<3, float>": _step(_PREFIX, 9, 48, 4720),
    "prefix_scan_rows_kernel<__nv_bfloat16>": _rows(_PREFIX, 10, 32, 4688, "coop_scan"),
    "prefix_search_rows_kernel<true, __nv_bfloat16>": _rows(_PREFIX, 11, 31, 0),
    "prefix_search_tree_kernel<true, false, __nv_bfloat16>": _rows(_PREFIX, 12, 32, 0,
                                                                   "coop_search"),
    "prefix_search_tree_kernel<true, true, __nv_bfloat16>": _rows(_PREFIX, 13, 32, 0,
                                                                  "coop_search"),
    "prefix_step_rows_kernel<0, __nv_bfloat16>": _step(_PREFIX, 14, 63, 4720),
    "prefix_step_rows_kernel<1, __nv_bfloat16>": _step(_PREFIX, 15, 48, 4720),
    "prefix_step_rows_kernel<2, __nv_bfloat16>": _step(_PREFIX, 16, 48, 4720),
    "prefix_step_rows_kernel<3, __nv_bfloat16>": _step(_PREFIX, 17, 48, 4720),
    "prefix_scan_rows_kernel<__half>": _rows(_PREFIX, 18, 32, 4688, "coop_scan"),
    "prefix_search_rows_kernel<true, __half>": _rows(_PREFIX, 19, 31, 0),
    "prefix_search_tree_kernel<true, false, __half>": _rows(_PREFIX, 20, 32, 0,
                                                            "coop_search"),
    "prefix_search_tree_kernel<true, true, __half>": _rows(_PREFIX, 21, 32, 0,
                                                           "coop_search"),
    "prefix_step_rows_kernel<0, __half>": _step(_PREFIX, 22, 63, 4720),
    "prefix_step_rows_kernel<1, __half>": _step(_PREFIX, 23, 48, 4720),
    "prefix_step_rows_kernel<2, __half>": _step(_PREFIX, 24, 48, 4720),
    "prefix_step_rows_kernel<3, __half>": _step(_PREFIX, 25, 48, 4720),
    "copy_kernel": _rows(_FIX, 0, 32, 0, "resident"),
    "iota_kernel": _rows(_FIX, 1, 32, 0, "resident"),
    # The AIS schedule's row reduction: a block of 1024 threads a row, its
    # warps' 32 values in static shared memory.
    "logsumexp_rows_kernel": KernelResources(_REDUCE, 0, 39, 128, "row", threads=1024),
}


@dataclasses.dataclass(frozen=True)
class Footprint:
    """What one launch of ``kernel`` over ``rows`` x ``n`` holds."""

    kernel: str
    rows: int
    n: int
    threads: int
    registers: int
    static_smem: int
    dynamic_smem: int
    blocks: int
    grid_y: int
    per_sm: int
    cooperative: bool
    optin: bool = False

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem


def blocks_per_sm(registers: int, smem: int, threads: int = NT, limits=None) -> int:
    """Blocks of ``threads`` co-resident on one SM, by the occupancy rule:
    registers per warp in units of 256, shared memory per block plus its
    reserve in units of 128, threads and blocks per SM."""
    lim = CARD_LIMITS if limits is None else limits
    warps = -(-threads // WARP)
    regs_warp = -(-registers * WARP // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_regs = lim["regs_per_sm"] // regs_warp // warps
    block_smem = -(-(smem + lim["smem_reserved_per_block"]) // SMEM_ALLOC_UNIT) * SMEM_ALLOC_UNIT
    by_smem = lim["smem_per_sm"] // block_smem
    return min(by_regs, by_smem, lim["threads_per_sm"] // threads, lim["blocks_per_sm"])


def price(kernel: str, rows: int, n: int, resources: KernelResources | None = None
          ) -> Footprint:
    """The footprint of one launch of ``kernel`` over a bank of ``rows`` x
    ``n`` (``resources`` for a kernel outside ``KERNELS``), without
    launching it."""
    res = KERNELS[kernel] if resources is None else resources
    dynamic = rows * res.smem_per_row + rows * n * res.smem_per_element
    per_sm = blocks_per_sm(res.registers, res.static_smem + dynamic, res.threads)
    co_resident = per_sm * CARD_LIMITS["sms"]
    grid_y = 1
    if res.grid == "row":
        blocks = rows
    elif res.grid == "rows":
        blocks, grid_y = -(-n // NT), rows
    elif res.grid == "tiles":
        blocks, grid_y = n // 1024, rows
    elif res.grid == "resident":
        blocks = max(1, min(co_resident, -(-rows * n // (4 * NT))))
    elif res.grid in ("coop_step", "coop_search"):
        blocks = max(1, min(co_resident, -(-rows * n // NT)))
    else:
        blocks = max(1, min(co_resident, rows * (n // 1024)))
    return Footprint(kernel, rows, n, res.threads, res.registers, res.static_smem, dynamic,
                     blocks * grid_y, grid_y, per_sm, res.cooperative, res.optin)


def smem_findings(footprints) -> list:
    """Findings for every launch over the card's limits: shared memory per
    block (48 KiB without the opt-in; 227 KiB for a kernel that opts in,
    the Megopolis step alone), registers per thread and per SM, a grid's rows past
    65535, and a block that fits no SM.  A cooperative grid is co-resident
    by its construction (``price`` caps it at ``per_sm`` x SMs, as
    ``coop_step_grid`` does); ``card_drift`` holds ``per_sm`` to the
    card's occupancy query."""
    findings = []
    for fp in footprints:
        problems = []
        budget = CARD_LIMITS["smem_per_block_optin" if fp.optin else "smem_per_block"]
        if fp.smem > budget:
            problems.append(
                f"{fp.smem} bytes of shared memory per block (budget "
                f"{CARD_LIMITS['smem_per_block']} without the opt-in, "
                f"{CARD_LIMITS['smem_per_block_optin']} with it; this kernel "
                f"{'opts in' if fp.optin else 'does not opt in'})")
        if fp.registers > REGS_PER_THREAD or fp.registers * fp.threads > CARD_LIMITS["regs_per_sm"]:
            problems.append(f"{fp.registers} registers x {fp.threads} threads")
        if fp.grid_y > 65535:
            problems.append(f"{fp.grid_y} rows on grid.y (most 65535)")
        if fp.per_sm < 1:
            problems.append("no block fits an SM")
        if problems:
            findings.append(Finding(
                "smem", "over-budget", f"{fp.kernel}@S={fp.rows},N={fp.n}",
                f"launch over the card's limits: {'; '.join(problems)} (grid {fp.blocks} "
                f"blocks of {fp.threads})"))
    return findings


def largest_shapes(kernel: str) -> list:
    """The largest ``(rows, N)`` the wrappers admit for ``kernel``: one row
    of ``MAX_PARTICLES``, and the most rows of a launch (``MAX_STEP_ROWS``
    for a step, ``MAX_ROWS`` for a bank) at the largest N, a multiple of
    1024, with ``S·N < 2**31``."""
    if KERNELS[kernel].grid == "resident":
        return [(1, MAX_PARTICLES)]
    rows = MAX_STEP_ROWS if KERNELS[kernel].grid == "coop_step" else MAX_ROWS
    return [(1, MAX_PARTICLES), (rows, MAX_ELEMENTS // rows // 1024 * 1024)]


def large_n_footprints() -> list:
    """Every kernel of ``KERNELS`` priced at its largest admitted shapes,
    without launching anything: ``(cell, [Footprint])`` pairs."""
    return [(f"large_n/{kernel}@S={rows},N={n}", [price(kernel, rows, n)])
            for kernel in KERNELS for rows, n in largest_shapes(kernel)]


# ------------------------------------------------------------- on the card
def _stem(source: str) -> str:
    return Path(source).stem


def _attributes(kernel: str, dynamic_smem: int) -> tuple:
    from repro_torch.kernels.build import load

    res = KERNELS[kernel]
    fn = getattr(load(res.source), f"{_stem(res.source)}_attributes")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 4)()
    err = fn(res.index, dynamic_smem, vals)
    if err != 0:
        raise RuntimeError(f"{kernel}: cudaFuncGetAttributes or the occupancy query failed "
                           f"({err})")
    return tuple(vals)


def card_attributes() -> dict:
    """Each kernel's attributes as the runtime reports them on the current
    card: ``{kernel: (registers, static smem, largest block, blocks per SM
    at no dynamic shared memory)}``.  Builds the libraries if needed."""
    return {kernel: _attributes(kernel, 0) for kernel in KERNELS}


def card_per_sm(kernel: str, dynamic_smem: int) -> int:
    """Blocks of ``kernel`` co-resident on one SM of the current card with
    ``dynamic_smem`` bytes of dynamic shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _attributes(kernel, dynamic_smem)[3]


def card_limits() -> dict:
    """``CARD_LIMITS`` as ``cudaDeviceGetAttribute`` reports them on the
    current card."""
    from repro_torch.kernels.build import load

    fn = load(_FIX).fixtures_device_limits
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * len(CARD_LIMITS))()
    if fn(vals) != 0:
        raise RuntimeError("cudaDeviceGetAttribute failed")
    return dict(zip(CARD_LIMITS, vals))


def card_drift() -> list:
    """Where the current card differs from ``CARD_LIMITS`` and ``KERNELS``:
    its limits, each kernel's registers and static shared memory, the
    largest block (at least ``NT``), and each cooperative kernel's blocks
    per SM at one row and at ``MAX_STEP_ROWS`` rows against
    ``blocks_per_sm``'s.  Empty when the tables are the card's."""
    drift = [f"limit {k}: card {v}, table {CARD_LIMITS[k]}"
             for k, v in card_limits().items() if v != CARD_LIMITS[k]]
    for kernel, (regs, smem, most, per_sm) in card_attributes().items():
        res = KERNELS[kernel]
        if (regs, smem) != (res.registers, res.static_smem) or most < res.threads:
            drift.append(f"{kernel}: card {regs} registers, {smem} bytes static smem, blocks "
                         f"up to {most}; table {res.registers}, {res.static_smem}")
        for rows in ((1, MAX_STEP_ROWS) if res.cooperative else (1,)):
            dyn = rows * res.smem_per_row
            want = blocks_per_sm(res.registers, res.static_smem + dyn, res.threads)
            got = per_sm if dyn == 0 else card_per_sm(kernel, dyn)
            if got != want:
                drift.append(f"{kernel}: {got} blocks per SM on the card at {dyn} bytes of "
                             f"dynamic smem, {want} by the table")
    return drift
