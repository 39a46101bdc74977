"""Launch wrappers of the prefix-sum search kernel, one per TPU kernel (after
``repro.kernels.prefix_sum.search``):

    searchsorted_rows            <- searchsorted_pallas            (kernel: <false, false>)
    searchsorted_gather_rows     <- searchsorted_gather_pallas     (kernel: <true, false>)
    residual_select_gather_rows  <- residual_select_gather_pallas  (kernel: <true, true>)

``side`` follows ``jnp.searchsorted``: ``"left"`` the first index with
``c >= u``, ``"right"`` the first with ``c > u``, clipped to N - 1.  Each
wrapper takes a bank of S rows (one population is a bank of one row);
state is ``[S, D, N]``.  The wrappers behave as that of ``prefix_sum.py``:
plain version on CPU tensors, the kernel or an error on CUDA tensors, one
count per launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import check_launch, kernel_wrapper
from repro_torch.kernels.prefix_sum.prefix_sum import _lib, check_rows, ptr, stream
from repro_torch.kernels.prefix_sum.ref import residual_select_rows_ref, search_rows_ref

SIDES = ("left", "right")


def _search(who, cdf, u, side, state=None, cc=None, n_det=None):
    """One launch of ``prefix_search_rows_kernel`` over a bank (the residual
    select when ``cc`` is given), or its plain version on CPU tensors."""
    if side not in SIDES:
        raise ValueError(f"{who}: side must be one of {SIDES}; got {side!r}")
    s, n, d = check_rows(who, cdf, u, cc, state=state)
    if cc is not None and tuple(n_det.shape) != (s,):
        raise ValueError(f"{who}: n_det must be [S] = [{s}]; got {list(n_det.shape)}")
    if not cdf.is_cuda:
        if cc is None:
            return search_rows_ref(cdf, u, side == "right", state)
        return residual_select_rows_ref(cc, cdf, u, n_det, state)
    anc = torch.empty((s, n), dtype=torch.int32, device=cdf.device)
    out = None if state is None else torch.empty_like(state)
    nd = None if cc is None else n_det.to(device=cdf.device, dtype=torch.int32)
    check_launch(_lib().prefix_search_rows(
        cdf.data_ptr(), ptr(cc), u.data_ptr(), ptr(nd), ptr(state), anc.data_ptr(), ptr(out),
        s, n, d, int(side == "right"), stream(cdf)), who)
    return anc if state is None else (anc, out)


@kernel_wrapper("prefix_search_rows_kernel<false, false>")
def searchsorted_rows(cdf: torch.Tensor, u: torch.Tensor, side: str = "left"):
    """Bisect each row of the CDF bank ``cdf f32[S, N]`` at ``u f32[S, N]``:
    ancestors ``int32[S, N]``."""
    anc = _search("searchsorted_rows", cdf, u, side)
    searchsorted_rows.launches += cdf.is_cuda
    return anc


@kernel_wrapper("prefix_search_rows_kernel<true, false>")
def searchsorted_gather_rows(cdf: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                             side: str = "left"):
    """``searchsorted_rows`` plus the copy of each ancestor's state ``[S, D,
    N]``: ``(ancestors int32[S, N], state' [S, D, N])``."""
    result = _search("searchsorted_gather_rows", cdf, u, side, state)
    searchsorted_gather_rows.launches += cdf.is_cuda
    return result


@kernel_wrapper("prefix_search_rows_kernel<true, true>")
def residual_select_gather_rows(cc: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
                                n_det: torch.Tensor, state: torch.Tensor):
    """Residual resampling's tail over a bank: slot ``i < n_det[s]`` takes
    the ``right`` bisection of the count CDF ``cc`` at ``i``, the others
    that of the residual CDF ``c`` at ``u``; then the state copy.  Returns
    ``(ancestors int32[S, N], state' [S, D, N])``."""
    result = _search("residual_select_gather_rows", c, u, "right", state, cc, n_det)
    residual_select_gather_rows.launches += c.is_cuda
    return result


WRAPPERS = (searchsorted_rows, searchsorted_gather_rows, residual_select_gather_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
