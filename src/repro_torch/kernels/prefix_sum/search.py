"""Launch wrappers of the prefix-sum search kernels, one per TPU kernel (after
``repro.kernels.prefix_sum.search``):

    searchsorted_rows            <- searchsorted_pallas            (kernels: rows<false, u32>,
                                                                    tree<false, false, u32>)
    searchsorted_gather_rows     <- searchsorted_gather_pallas     (kernels: rows<true, S>,
                                                                    tree<true, false, S>)
    residual_select_gather_rows  <- residual_select_gather_pallas  (kernel: tree<true, true, S>)

``side`` follows ``jnp.searchsorted``: ``"left"`` the first index with
``c >= u``, ``"right"`` the first with ``c > u``, clipped to N - 1.  Each
wrapper takes a bank of S rows (one population is a bank of one row);
state is ``[S, D, N]`` of any plane dtype or int32, copied as words of its
own width (the kernels' instance of that word S, ``uint32_t`` or
``uint16_t``: a copy does no arithmetic); the CDFs and the draws are
float32.  The
wrappers behave as that of ``prefix_sum.py``: plain version on CPU tensors,
the kernel or an error on CUDA tensors, one count per launch.

Two kernels compute the same bisection.  Draws that rise with the slot
(``rising``: the systematic and stratified kinds, residual's count slots)
go to ``prefix_search_rows_kernel``, one thread a slot: a warp's 32 paths
coincide, so the CDF's first steps stay in L1.  Draws in no order
(multinomial, residual's other slots) go to ``prefix_search_tree_kernel``,
which first writes each CDF row's search tree (``ref.search_tree``) into a
scratch buffer the wrapper allocates, then reads one 32-byte line of it for
every three steps where the bisection reads three scattered sectors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    PLANE_DTYPES,
    check_launch,
    kernel_wrapper,
    state_bytes,
    state_word,
)
from repro_torch.kernels.prefix_sum.prefix_sum import _lib, check_rows, ptr, stream
from repro_torch.kernels.prefix_sum.ref import (
    TREE_LINE,
    residual_select_rows_ref,
    search_rows_ref,
    search_tree_lines,
)

SIDES = ("left", "right")


def tree_floats(n: int) -> int:
    """Floats of one CDF row's search tree (``prefix_search_tree_floats`` in
    ``csrc/prefix_sum.cu``): ``ref.search_tree``'s length."""
    return len(search_tree_lines(n)) * TREE_LINE


def _search(who, cdf, u, side, rising, state=None, cc=None, n_det=None):
    """One launch of a search kernel over a bank (the residual select when
    ``cc`` is given), or its plain version on CPU tensors."""
    if side not in SIDES:
        raise ValueError(f"{who}: side must be one of {SIDES}; got {side!r}")
    s, n, d = check_rows(who, cdf, u, cc, state=state, state_planes=PLANE_DTYPES)
    if cc is not None and tuple(n_det.shape) != (s,):
        raise ValueError(f"{who}: n_det must be [S] = [{s}]; got {list(n_det.shape)}")
    if not cdf.is_cuda:
        if cc is None:
            return search_rows_ref(cdf, u, side == "right", state)
        return residual_select_rows_ref(cc, cdf, u, n_det, state)
    anc = torch.empty((s, n), dtype=torch.int32, device=cdf.device)
    out = None if state is None else torch.empty_like(state)
    nd = None if cc is None else n_det.to(device=cdf.device, dtype=torch.int32)
    tree = None if rising else torch.empty(s * tree_floats(n), dtype=torch.float32,
                                           device=cdf.device)
    check_launch(_lib().prefix_search_rows(
        cdf.data_ptr(), ptr(cc), u.data_ptr(), ptr(nd), ptr(state), anc.data_ptr(), ptr(out),
        ptr(tree), 0 if tree is None else tree.numel(), s, n, d, int(side == "right"),
        state_bytes(state), stream(cdf)), who)
    return anc if state is None else (anc, out)


def _kernel(gather: bool):
    """The census name of a search wrapper's launch, by its ``rising``
    (positional after ``side``, or by keyword) and the word of its state
    (``unsigned int`` for the index-only search)."""
    g, at = str(gather).lower(), 4 if gather else 3

    def name(*args, rising=False, **_):
        word = state_word(args[2]) if gather else "unsigned int"
        if args[at] if len(args) > at else rising:
            return f"prefix_search_rows_kernel<{g}, {word}>"
        return f"prefix_search_tree_kernel<{g}, false, {word}>"
    return name


@kernel_wrapper(_kernel(False))
def searchsorted_rows(cdf: torch.Tensor, u: torch.Tensor, side: str = "left",
                      rising: bool = False):
    """Bisect each row of the CDF bank ``cdf f32[S, N]`` at ``u f32[S, N]``:
    ancestors ``int32[S, N]``.  ``rising``: the draws rise with the slot."""
    anc = _search("searchsorted_rows", cdf, u, side, rising)
    searchsorted_rows.launches += cdf.is_cuda
    return anc


@kernel_wrapper(_kernel(True))
def searchsorted_gather_rows(cdf: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                             side: str = "left", rising: bool = False):
    """``searchsorted_rows`` plus the copy of each ancestor's state ``[S, D,
    N]`` (a plane dtype): ``(ancestors int32[S, N], state' [S, D, N])``."""
    result = _search("searchsorted_gather_rows", cdf, u, side, rising, state)
    searchsorted_gather_rows.launches += cdf.is_cuda
    return result


@kernel_wrapper(lambda *args, **_: f"prefix_search_tree_kernel<true, true, {state_word(args[4])}>")
def residual_select_gather_rows(cc: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
                                n_det: torch.Tensor, state: torch.Tensor):
    """Residual resampling's tail over a bank: slot ``i < n_det[s]`` takes
    the ``right`` bisection of the count CDF ``cc`` at ``i``, the others
    that of the residual CDF ``c`` at ``u``; then the state copy.  Returns
    ``(ancestors int32[S, N], state' [S, D, N])``."""
    result = _search("residual_select_gather_rows", c, u, "right", False, state, cc, n_det)
    residual_select_gather_rows.launches += c.is_cuda
    return result


WRAPPERS = (searchsorted_rows, searchsorted_gather_rows, residual_select_gather_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
