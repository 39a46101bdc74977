"""Launch wrappers of the prefix-sum step kernel (after
``repro.kernels.prefix_sum.step``):

    prefix_step_rows  <- prefix_pallas_step  (kernel: prefix_step_rows_kernel<KIND, T, S>,
                                              a bank; the JAX package maps the single step)

One population is a bank of one row.  The log-weights and a float state
share one plane dtype, float32, bfloat16 or float16 (the kernel's instance
of that word T and of the state word S of its width); an int32 state rides
beside any of them (S = uint32_t); the kernel rounds its weights to that
word's grid and scans them into a float32 CDF, as the JAX step does (it
keeps them as float32 values, so its weights buffer is ``S·N`` floats at
every word).  The draw bases come from the caller,
as the JAX wrapper draws them from the key: ``ubase f32[S, N] =
uniform(key, (N,))`` for multinomial, stratified and residual (None for
the systematic kinds) and ``u0 f32[S] = uniform(key, ())`` for the
systematic kinds (None otherwise); the kernel scales them over its own
scan.  ``residual`` takes N <= 2**24.  The wrapper behaves as
that of ``prefix_sum.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    PLANE_CODES,
    PLANE_DTYPES,
    TILE,
    check_launch,
    kernel_wrapper,
    plane_word,
    state_bytes,
    state_word,
    step_buffers,
)
from repro_torch.kernels.prefix_sum.prefix_sum import _lib, check_rows, ptr, stream
from repro_torch.kernels.prefix_sum.ref import (
    KIND_CODES,
    RESIDUAL_MAX_PARTICLES,
    draws_rise,
    prefix_step_rows_ref,
)
from repro_torch.kernels.prefix_sum.search import tree_floats


def check_kind(who: str, kind: str, n: int):
    """Raise on an unknown kind, and on ``residual`` above N = 2**24."""
    if kind not in KIND_CODES:
        raise ValueError(f"{who}: kind must be one of {tuple(KIND_CODES)}; got {kind!r}")
    if kind == "residual" and n > RESIDUAL_MAX_PARTICLES:
        raise ValueError(
            f"{who}: residual resampling scans and sums its counts in f32, exact only up to "
            f"N = 2**24; got N={n}")


def _step(who, lw, state, ubase, u0, thr, kind):
    s, n, d = check_rows(who, lw, ubase, state=state, planes=PLANE_DTYPES)
    check_kind(who, kind, n)
    code = KIND_CODES[kind]
    if (ubase is None) != (code == 1) or (u0 is None) != (code != 1):
        raise ValueError(f"{who}: {kind} takes " + ("u0 [S]" if code == 1 else "ubase [S, N]"))
    if u0 is not None:
        if tuple(u0.shape) != (s,):
            raise ValueError(f"{who}: u0 must be [S] = [{s}]; got {list(u0.shape)}")
        u0 = u0.to(device=lw.device, dtype=torch.float32).contiguous()
    if not lw.is_cuda:
        return prefix_step_rows_ref(lw, state, ubase, u0, thr, kind)
    lib = _lib()
    plane, sb = PLANE_CODES[lw.dtype], state_bytes(state)
    g, anc, out, stats, scratch = step_buffers(
        lambda rows, n_, blocks: lib.prefix_step_grid(code, rows, n_, sb, plane, blocks), who, lw,
        state, 0, wbuf_word=4)
    t = n // TILE
    # The kernel's work space: for the draws in no order (multinomial,
    # residual's residuals) a search tree a row first; then the tile
    # carries, and for residual the CDF of the weights, the counts and
    # residuals, their carries and n_det's sums.
    size = s * tree_floats(n) if not draws_rise(kind) else 0
    size += s * t if code != 3 else 3 * s * n + 2 * s * t + s * g
    work = torch.empty(size, dtype=torch.float32, device=lw.device)
    check_launch(lib.prefix_step_rows(
        code, lw.data_ptr(), state.data_ptr(), ptr(ubase), ptr(u0), float(thr), anc.data_ptr(),
        out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), work.data_ptr(), s, n, d, g,
        sb, plane, stream(lw)), who)
    return anc, out, stats


def _step_kernel(lw, state, ubase, u0, thr, kind):
    """The instance of the step kernel a call launches."""
    return f"prefix_step_rows_kernel<{KIND_CODES[kind]}, {plane_word(lw)}, {state_word(state)}>"


@kernel_wrapper(_step_kernel)
def prefix_step_rows(lw: torch.Tensor, state: torch.Tensor, ubase, u0, thr: float, kind: str):
    """Fused SMC step over a bank of log-weights ``[S, N]`` (a plane dtype;
    the state of the same), each row with its own decision ``ess_norm <
    thr``.  Returns ``(ancestors int32[S, N],
    state' [S, D, N], stats f32[S, 4])``."""
    result = _step("prefix_step_rows", lw, state, ubase, u0, thr, kind)
    prefix_step_rows.launches += lw.is_cuda
    return result


WRAPPERS = (prefix_step_rows,)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
