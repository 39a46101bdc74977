"""Card-only tests of the port: the CUDA kernels against their plain
versions (Megopolis, with its rings of segment copies across ring depths,
bank sizes, boundary offsets and the most rows a step admits, and its refusal
of misaligned weights; Metropolis, at N not a power of two and across
chunks of its prefixes; Metropolis-C1/C2, with C2's ring of partition
tiles across its depths, subnormal partition tiles, every product and
compare of its PTX flushing subnormals and the refusal of misaligned
weights; rejection, the prefix-sum
kinds, the contract checks' two fixture kernels, the iota's offset views;
the bfloat16 and float16 instances of every kernel of rows 1-29),
the filter's default device, and the contract checks on the card (the resource tables are the
card's, the census equals the profiler's count, the selftest passes).  They skip without a card
(this file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``)."""

import collections
import contextlib
import ctypes
import re
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch import random as trandom
from repro_torch.analysis import contracts, smem
from repro_torch.analysis import fixtures as afix
from repro_torch.core.spec import (
    MegopolisSpec,
    MetropolisC1Spec,
    MetropolisC2Spec,
    MetropolisSpec,
    PrefixSumSpec,
    RejectionSpec,
    launch_budget,
)
from repro_torch.kernels.common import MAX_STEP_ROWS, megopolis_indices
from repro_torch.kernels.fixtures import fixtures as fk
from repro_torch.kernels.fixtures import ref as fref
from repro_torch.kernels.megopolis import megopolis as mk
from repro_torch.kernels.megopolis import ref
from repro_torch.kernels.metropolis import c1c2 as ck
from repro_torch.kernels.metropolis import metropolis as tk
from repro_torch.kernels.metropolis import ref as tref
from repro_torch.kernels.prefix_sum import prefix_sum as pk
from repro_torch.kernels.prefix_sum import ref as pref
from repro_torch.kernels.prefix_sum import search as sk
from repro_torch.kernels.prefix_sum import step as stk
from repro_torch.kernels.rejection import ref as rref
from repro_torch.kernels.rejection import rejection as rk
from repro_torch.pf.filter import ParticleFilter, run_filter, simulate
from repro_torch.pf.models import ungm


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _inputs(dev, s=4, n=8192, b=16):
    g = torch.Generator().manual_seed(0)
    w = torch.rand(s, n, generator=g) ** 8
    w[:, ::7] = 1e-39  # subnormal weights: flushed by the kernel and the plain version
    lw = -0.5 * (torch.rand(s, n, generator=g) * 12) ** 2
    lw[s - 1] = float("-inf")  # a dead row runs on the uniform bank
    state = torch.randn(s, 2, n, generator=g)
    offsets = torch.randint(0, n, (s, b), generator=g, dtype=torch.int32)
    seeds = torch.randint(0, 2**32, (s,), generator=g)
    return w.to(dev), lw.to(dev), state.to(dev), offsets, seeds


@pytest.mark.cuda
def test_fused_rows_kernel_matches_plain_version(card):
    w, _, state, offsets, seeds = _inputs(card)
    mk.reset_launch_counts()
    anc, out = mk.megopolis_fused_rows(w, state, offsets, seeds)
    want_anc, want_out = ref.megopolis_fused_rows_ref(w, state, offsets, seeds)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert mk.megopolis_fused_rows.launches == 1


@pytest.mark.cuda
def test_step_rows_kernel_matches_plain_version(card):
    _, lw, state, offsets, seeds = _inputs(card)
    mk.reset_launch_counts()
    anc, out, stats = mk.megopolis_step_rows(lw, state, offsets, seeds, 0.5)
    want_anc, want_out, want_stats = ref.megopolis_step_rows_ref(lw, state, offsets, seeds, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
    # Sums in another order than torch.sum: rtol 1e-5 on ess_norm and
    # max_weight, atol 1e-5 on the evidence increment (nan on the dead row).
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    again = mk.megopolis_step_rows(lw, state, offsets, seeds, 0.5)[2]
    assert torch.equal(again, stats)  # fixed-order sums: the same stats every launch
    assert mk.megopolis_step_rows.launches == 2


@pytest.mark.cuda
def test_run_filter_defaults_to_the_card(card):
    key = trandom.PRNGKey(0)
    _, obs = simulate(key, ungm(), 5)
    pf = ParticleFilter(ungm(), 8192, resampler=MegopolisSpec(num_iters=8), ess_threshold=0.5)
    mk.reset_launch_counts()
    est = run_filter(key, pf, obs)
    assert est.is_cuda and est.shape == (5,) and torch.isfinite(est).all()
    assert mk.megopolis_step.launches == 5


@pytest.mark.cuda
@pytest.mark.parametrize("n", (8192, 3072))
def test_megopolis_index_only_kernel_matches_plain_version(card, n):
    w, _, _, offsets, seeds = _inputs(card, n=n)
    mk.reset_launch_counts()
    want = ref.megopolis_rows_ref(w, offsets, seeds)
    assert torch.equal(mk.megopolis_rows(w, offsets, seeds), want)
    assert torch.equal(mk.megopolis_batch(w, offsets[0], seeds),
                       ref.megopolis_rows_ref(w, offsets[:1].expand_as(offsets), seeds))
    assert torch.equal(mk.megopolis(w[1], offsets[1], seeds[1]), want[1])
    # The index-only instance selects what the fused one does.
    assert torch.equal(mk.megopolis_fused_rows(w, w[:, None], offsets, seeds)[0], want)
    assert (mk.megopolis_rows.launches, mk.megopolis_batch.launches, mk.megopolis.launches) == (
        1, 1, 1)


#: Buffers of the Megopolis kernels' rings of comparison segments (the
#: ``*_STAGES`` defines of their source): the iteration counts below
#: straddle each depth.
RING_STAGES = sorted({int(d) for d in re.findall(r"#define \w+_STAGES(?:_2B)? (\d+)", (
    Path(mk.__file__).parent / "csrc" / "megopolis.cu").read_text())})
#: (N, S, B) of the ring cases: one segment and Path A's width; B = 1, each
#: ring's depth less one, itself and one more, and Path B's y = 4 (354, past
#: one chunk of 256 iterations); one, 16 and 64 rows.
RING_CASES = sorted({
    (1024, 1, 1), (1024, 16, 354), (1 << 20, 1, 1), (1 << 20, 1, 354),
    *((1024, s, d + e) for d in RING_STAGES for e, s in ((-1, 16), (0, 64), (1, 1))),
    *(((1 << 20), s, d + e) for d in RING_STAGES for e, s in ((-1, 16), (0, 64), (1, 16))),
})


def _ring_inputs(dev, n, s, b):
    """Weights with zeros and subnormals; log-weights whose row 0 is
    degenerate (all -inf: the uniform 1/N bank), row 1 (when there is one)
    all equal, neither firing at the threshold 0.5 (ess_norm = 1), and the
    others firing; state of two planes."""
    g = torch.Generator().manual_seed(n + 7 * s + b)
    w = torch.rand(s, n, generator=g) ** 8
    w[:, ::5] = 0.0
    w[:, 1::7] = 1e-39
    lw = -0.5 * (torch.rand(s, n, generator=g) * 12) ** 2
    lw[0] = float("-inf")
    if s > 1:
        lw[1] = 0.0
    state = torch.randn(s, 2, n, generator=g)
    offsets = torch.randint(0, n, (s, b), generator=g, dtype=torch.int32)
    seeds = torch.randint(0, 2**32, (s,), generator=g)
    return w.to(dev), lw.to(dev), state.to(dev), offsets, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,b", RING_CASES)
def test_megopolis_ring_kernels_match_plain_version(card, n, s, b):
    w, lw, state, offsets, seeds = _ring_inputs(card, n, s, b)
    mk.reset_launch_counts()
    assert torch.equal(mk.megopolis_rows(w, offsets, seeds),
                       ref.megopolis_rows_ref(w, offsets, seeds))
    anc, out = mk.megopolis_fused_rows(w, state, offsets, seeds)
    want_anc, want_out = ref.megopolis_fused_rows_ref(w, state, offsets, seeds)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    anc, out, stats = mk.megopolis_step_rows(lw, state, offsets, seeds, 0.5)
    want_anc, want_out, want_stats = ref.megopolis_step_rows_ref(lw, state, offsets, seeds, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    ids = torch.arange(n, dtype=torch.int32, device=card)
    assert stats[0, 2] == 0.0 and torch.equal(anc[0], ids)  # degenerate: kept
    if s > 1:
        assert stats[1, 2] == 0.0 and torch.equal(anc[1], ids)  # did not fire: kept
        assert bool(stats[2:, 2].all())  # the others resampled
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert (mk.megopolis_rows.launches, mk.megopolis_fused_rows.launches,
            mk.megopolis_step_rows.launches) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1024, 2048, 8192))
def test_megopolis_kernels_at_boundary_offsets(card, n):
    """Row s has the s-th of the offsets 0, 1, 7, 8, 1023, 1024, 1025, the
    middle and the last ones (whose lanes wrap past the row's end), and B =
    1 on equal weights, so every particle accepts its
    comparison: each kernel's ancestors are ``megopolis_indices`` at that
    offset, as is the plain version's."""
    offs = sorted({o for o in (0, 1, 7, 8, 1023, 1024, 1025, n // 2 + 3, n - 1024,
                               n - 1023, n - 1) if o < n})
    s = len(offs)
    w = torch.ones(s, n, device=card)
    offsets = torch.tensor(offs, dtype=torch.int32)[:, None]
    seeds = torch.arange(s, dtype=torch.int64)
    i = torch.arange(n, dtype=torch.int64)
    want = torch.stack([megopolis_indices(i, torch.tensor(o), 1024, n) for o in offs])
    want = want.to(device=card, dtype=torch.int32)
    state = torch.arange(s * n, dtype=torch.float32, device=card).reshape(s, 1, n)
    assert torch.equal(ref.megopolis_rows_ref(w, offsets, seeds), want)
    assert torch.equal(mk.megopolis_rows(w, offsets, seeds), want)
    anc, out = mk.megopolis_fused_rows(w, state, offsets, seeds)
    assert torch.equal(anc, want) and torch.equal(out, torch.gather(state, 2, want[:, None].long()))
    # Equal log-weights: ess_norm = 1 < 2 fires every row.
    anc, _, stats = mk.megopolis_step_rows(torch.zeros(s, n, device=card), state, offsets, seeds,
                                           2.0)
    assert bool(stats[:, 2].all()) and torch.equal(anc, want)


@pytest.mark.cuda
def test_megopolis_step_kernel_at_the_most_rows(card):
    # 4096 rows: the ring and the per-row shift and flags pass 48 KiB, so the
    # launch needs the kernel's opt-in.
    _, lw, state, offsets, seeds = _ring_inputs(card, 1024, MAX_STEP_ROWS, 3)
    anc, out, stats = mk.megopolis_step_rows(lw, state, offsets, seeds, 0.5)
    want_anc, want_out, want_stats = ref.megopolis_step_rows_ref(lw, state, offsets, seeds, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ("megopolis", "megopolis_batch", "megopolis_rows",
                                     "megopolis_fused", "megopolis_fused_rows"))
def test_megopolis_misaligned_weights_raise(card, wrapper):
    n = 2048
    w = torch.rand(2 * n + 1, device=card)[1:]  # 4 bytes past a 16-byte boundary
    state = torch.zeros(1, n, device=card)
    offsets, seed = torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, dtype=torch.int64)
    args = {"megopolis": (w[:n], offsets[0], seed[0]),
            "megopolis_batch": (w.view(2, n), offsets[0], seed.expand(2)),
            "megopolis_rows": (w.view(2, n), offsets.expand(2, -1), seed.expand(2)),
            "megopolis_fused": (w[:n], state, offsets[0], seed[0]),
            "megopolis_fused_rows": (w[:n].view(1, n), state[None], offsets, seed)}[wrapper]
    mk.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        getattr(mk, wrapper)(*args)
    assert getattr(mk, wrapper).launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", (8192, 3072))
def test_metropolis_rows_kernel_matches_plain_version(card, n):
    w, _, state, _, seeds = _inputs(card, n=n)
    tk.reset_launch_counts()
    want_anc, want_out = tref.metropolis_rows_ref(w, state, seeds, 16)
    anc, out = tk.metropolis_fused_batch(w, state, seeds, 16)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(tk.metropolis_batch(w, seeds, 16), want_anc)
    assert torch.equal(tk.metropolis(w[2], seeds[2], 16), want_anc[2])
    assert torch.equal(tk.metropolis_fused(w[2], state[2], seeds[2], 16)[1], want_out[2])
    assert [fn.launches for fn in tk.WRAPPERS[:4]] == [1, 1, 1, 1]


@pytest.mark.cuda
def test_metropolis_step_kernel_matches_plain_version(card):
    _, lw, state, _, seeds = _inputs(card)
    tk.reset_launch_counts()
    anc, out, stats = tk.metropolis_step_rows(lw, state, seeds, 16, 0.5)
    want_anc, want_out, want_stats = tref.metropolis_step_rows_ref(lw, state, seeds, 16, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
    # Sums in another order than torch.sum: as the Megopolis step kernel.
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(tk.metropolis_step_rows(lw, state, seeds, 16, 0.5)[2], stats)
    one = tk.metropolis_step(lw[0], state[0], seeds[0], 16, 0.5)
    assert torch.equal(one[0], want_anc[0])
    assert (tk.metropolis_step_rows.launches, tk.metropolis_step.launches) == (2, 1)


@pytest.mark.cuda
def test_run_filter_with_metropolis_on_the_card(card):
    key = trandom.PRNGKey(0)
    _, obs = simulate(key, ungm(), 5)
    pf = ParticleFilter(ungm(), 8192, resampler=MetropolisSpec(num_iters=8), ess_threshold=0.5)
    tk.reset_launch_counts()
    est = run_filter(key, pf, obs)
    assert est.is_cuda and est.shape == (5,) and torch.isfinite(est).all()
    assert tk.metropolis_step.launches == 5


def _tables(dev, variant, s, n, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    width = n // 1024 * (1 if variant == 1 else b)
    return torch.randint(0, n // 1024, (s, width), generator=g, dtype=torch.int32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
@pytest.mark.parametrize("n,b", ((8192, 16), (3072, 16), (8192, 300)))
def test_c1c2_rows_kernel_matches_plain_version(card, variant, n, b):
    """Three tiles (N = 3072) and more iterations than one chunk of
    prefixes (B = 300)."""
    w, _, state, _, seeds = _inputs(card, n=n)
    parts = _tables(card, variant, w.shape[0], n, b)
    ck.reset_launch_counts()
    c = f"metropolis_c{variant}"
    want_anc, want_out = tref.metropolis_c1c2_rows_ref(w, state, parts, seeds, b, variant)
    anc, out = getattr(ck, c + "_fused_batch")(w, state, parts, seeds, b)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(getattr(ck, c + "_batch")(w, parts, seeds, b), want_anc)
    assert torch.equal(getattr(ck, c)(w[2], parts[2], seeds[2], b), want_anc[2])
    assert torch.equal(getattr(ck, c + "_fused")(w[2], state[2], parts[2], seeds[2], b)[1],
                       want_out[2])
    counts = [getattr(ck, c + sfx).launches for sfx in ("", "_batch", "_fused", "_fused_batch")]
    assert counts == [1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
def test_c1c2_step_kernel_matches_plain_version(card, variant):
    _, lw, state, _, seeds = _inputs(card)
    parts = _tables(card, variant, lw.shape[0], lw.shape[1], 16)
    ck.reset_launch_counts()
    c = f"metropolis_c{variant}"
    anc, out, stats = getattr(ck, c + "_step_rows")(lw, state, parts, seeds, 16, 0.5)
    want_anc, want_out, want_stats = tref.metropolis_c1c2_step_rows_ref(
        lw, state, parts, seeds, 16, 0.5, variant)
    assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
    # Sums in another order than torch.sum: as the Megopolis step kernel.
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(getattr(ck, c + "_step_rows")(lw, state, parts, seeds, 16, 0.5)[2], stats)
    one = getattr(ck, c + "_step")(lw[0], state[0], parts[0], seeds[0], 16, 0.5)
    assert torch.equal(one[0], want_anc[0])
    assert (getattr(ck, c + "_step_rows").launches, getattr(ck, c + "_step").launches) == (2, 1)


def _source_define(module, stem: str, pattern: str) -> list:
    """The values of the ``#define``s matching ``pattern`` in a wrapper
    module's CUDA source ``csrc/<stem>.cu``."""
    text = (Path(module.__file__).parent / "csrc" / f"{stem}.cu").read_text()
    return sorted({int(v) for v in re.findall(rf"#define {pattern} (\d+)", text)})


#: Iterations that C2's rings hold (``C2_<kernel>_STAGES`` buffers of
#: ``C2_<kernel>_GROUP`` tiles): the iteration counts below straddle each,
#: one chunk of 256 prefixes, and end on whole and on partial groups.
C2_RING_ITERS = [s * g for s, g in zip(_source_define(ck, "c1c2", r"C2_ROWS_STAGES"),
                                       _source_define(ck, "c1c2", r"C2_ROWS_GROUP"))]
C2_RING_ITERS += [s * g for s, g in zip(_source_define(ck, "c1c2", r"C2_STEP_STAGES"),
                                        _source_define(ck, "c1c2", r"C2_STEP_GROUP"))]
C1C2_ITERS = sorted({1, 2, 257, 258, *(d + e for d in C2_RING_ITERS for e in (-1, 0, 1))})


def _redesign_inputs(dev, n, s, seed):
    """Weights with zeros, subnormals and a subnormal last tile; log-weights
    whose last row (of two or more) is degenerate (all -inf) and row 1 (of
    three or more) all equal, neither firing at 0.5, the others firing;
    state of two planes; seeds."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(s, n, generator=g) ** 8
    w[:, ::5] = 0.0
    w[:, 1::7] = 1e-39
    w[:, -1024:] = torch.rand(s, 1024, generator=g) * 1e-38  # subnormal
    lw = -0.5 * (torch.rand(s, n, generator=g) * 12) ** 2
    if s > 1:
        lw[-1] = float("-inf")
    if s > 2:
        lw[1] = 0.0
    state = torch.randn(s, 2, n, generator=g)
    seeds = torch.randint(0, 2**32, (s,), generator=g)
    return w.to(dev), lw.to(dev), state.to(dev), seeds


def _check_rows_and_step(dev, wrappers, plain, plain_step, w, lw, state, args, b):
    """The bank wrappers (index-only, fused, step) against their plain
    versions, bit for bit (the step's stats to the sums' tolerance), each
    launched once; ``args`` go between the state and the iterations."""
    batch, fused_batch, step_rows = wrappers
    for fn in wrappers:
        fn.launches = 0
    assert torch.equal(batch(w, *args, b), plain(w, None, *args, b))
    anc, out = fused_batch(w, state, *args, b)
    want_anc, want_out = plain(w, state, *args, b)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    anc, out, stats = step_rows(lw, state, *args, b, 0.5)
    want_anc, want_out, want_stats = plain_step(lw, state, *args, b, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    s, n = w.shape
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    assert stats[0, 2] == 1.0  # resampled
    if s > 1:
        assert stats[-1, 2] == 0.0 and torch.equal(anc[-1], ids)  # degenerate: kept
    if s > 2:
        assert stats[1, 2] == 0.0 and torch.equal(anc[1], ids)  # did not fire: kept
    assert [fn.launches for fn in wrappers] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
@pytest.mark.parametrize("s", (1, 3, 16))
@pytest.mark.parametrize("b", C1C2_ITERS)
def test_c1c2_ring_kernels_match_plain_version(card, variant, s, b):
    """C2's ring at iteration counts that straddle its depths and a chunk
    (C1 beside it), banks of 1, 3 and 16 rows, tables that reach tiles 0 and
    T - 1 (T = 3), weights with subnormals in the partition tiles."""
    n = 3072
    w, lw, state, seeds = _redesign_inputs(card, n, s, 100 * variant + 10 * s + b)
    parts = _tables(card, variant, s, n, b, seed=b)
    parts[:, 0], parts[:, -1] = 0, n // 1024 - 1
    c = f"metropolis_c{variant}"
    wrappers = tuple(getattr(ck, c + sfx) for sfx in ("_batch", "_fused_batch", "_step_rows"))

    def plain(w_, st, p_, sd, it):
        return tref.metropolis_c1c2_rows_ref(w_, st, p_, sd, it, variant)

    def plain_step(lw_, st, p_, sd, it, thr):
        return tref.metropolis_c1c2_step_rows_ref(lw_, st, p_, sd, it, thr, variant)

    _check_rows_and_step(card, wrappers, plain, plain_step, w, lw, state, (parts, seeds), b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
def test_c1c2_step_kernel_at_the_most_rows(card, variant):
    # 4096 rows: C2's ring and the per-row shift and flags pass 48 KiB, so
    # the launch needs the kernel's opt-in.
    n, s, b = 1024, MAX_STEP_ROWS, 5
    _, lw, state, seeds = _redesign_inputs(card, n, s, variant)
    parts = _tables(card, variant, s, n, b, seed=variant)
    c = f"metropolis_c{variant}"
    anc, out, stats = getattr(ck, c + "_step_rows")(lw, state, parts, seeds, b, 0.5)
    want_anc, want_out, want_stats = tref.metropolis_c1c2_step_rows_ref(
        lw, state, parts, seeds, b, 0.5, variant)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
def test_c1c2_kernels_on_subnormal_partition_tiles(card, variant):
    """Every partition tile mixes subnormal and tiny normal weights around
    FLT_MIN, so the sweep's products and compares flush in hardware what
    C2's bulk copies land raw: bit for bit as the plain version's explicit
    flushes."""
    n, s, b = 8192, 4, 40
    g = torch.Generator().manual_seed(variant)
    w = torch.rand(s, n, generator=g) * 3e-38
    w[:, ::2] = torch.rand(s, n // 2, generator=g) * 1.1e-38  # subnormal
    w[:, ::11] = 1.0
    w = w.to(card)
    state = torch.randn(s, 1, n, generator=g).to(card)
    seeds = torch.randint(0, 2**32, (s,), generator=g)
    parts = _tables(card, variant, s, n, b, seed=variant)
    c = f"metropolis_c{variant}"
    want_anc, want_out = tref.metropolis_c1c2_rows_ref(w, state, parts, seeds, b, variant)
    assert bool((want_anc != torch.arange(n, device=card)).any())  # something moved
    anc, out = getattr(ck, c + "_fused_batch")(w, state, parts, seeds, b)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(getattr(ck, c + "_batch")(w, parts, seeds, b), want_anc)


@pytest.mark.cuda
def test_c1c2_ptx_flushes_every_product_and_compare(card, tmp_path):
    """The sweep's flush is the hardware's (C2's bulk copies land the weights
    raw): with ``build.py``'s ``-ftz=true`` every f32 multiply and compare in
    ``c1c2.cu``'s PTX carries ``.ftz``.  Prints the counts."""
    from repro_torch.kernels import build as kbuild

    flags = [f for f in kbuild.NVCC_FLAGS if f.startswith(("-std", "-O", "-ftz"))]
    ptx = tmp_path / "c1c2.ptx"
    subprocess.run([kbuild._nvcc(), "-arch=compute_90a", *flags, "-ptx", "-o", str(ptx),
                    str(kbuild.KERNELS_DIR / ck.SOURCE)], capture_output=True, check=True)
    text = ptx.read_text()
    counts = {}
    for op, pat in (("mul", r"\bmul(?:\.rn)?(\.ftz)?\.f32\b"),
                    ("setp", r"\bsetp\.\w+?(\.ftz)?\.f32\b")):
        found = re.findall(pat, text)
        counts[op] = {"ftz": sum(1 for f in found if f), "all": len(found)}
    print(f"ptx {ck.SOURCE}: {counts}")
    assert all(c["all"] and c["ftz"] == c["all"] for c in counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,b", sorted({
    *((3072, s, b) for s in (1, 3, 16) for b in (1, 2, 3, 257)),
    (1024, 3, 257), (1024 * 7, 3, 9), (1 << 20, 1, 257)}))
def test_metropolis_kernels_at_more_shapes(card, n, s, b):
    """The Metropolis kernels at N not a power of two (1024·3, 1024·7: the
    unsigned remainder by N), iteration counts within and past a chunk of
    256 prefixes, banks of 1, 3 and 16 rows, and Path A's N."""
    w, lw, state, seeds = _redesign_inputs(card, n, s, n + 10 * s + b)
    wrappers = (tk.metropolis_batch, tk.metropolis_fused_batch, tk.metropolis_step_rows)
    _check_rows_and_step(card, wrappers, tref.metropolis_rows_ref, tref.metropolis_step_rows_ref,
                         w, lw, state, (seeds,), b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", (1, 2))
@pytest.mark.parametrize("entry", ("", "_batch", "_fused", "_fused_batch"))
def test_c1c2_misaligned_weights_raise(card, variant, entry):
    n, b = 2048, 4
    w = torch.rand(2 * n + 1, device=card)[1:]  # 4 bytes past a 16-byte boundary
    state = torch.zeros(1, n, device=card)
    parts = _tables(card, variant, 2, n, b)
    seed = torch.zeros(2, dtype=torch.int64)
    args = {"": (w[:n], parts[0], seed[0]), "_batch": (w.view(2, n), parts, seed),
            "_fused": (w[:n], state, parts[0], seed[0]),
            "_fused_batch": (w[:n].view(1, n), state[None], parts[:1], seed[:1])}[entry]
    fn = getattr(ck, f"metropolis_c{variant}{entry}")
    ck.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        fn(*args, b)
    assert fn.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cls", (MetropolisC1Spec, MetropolisC2Spec))
def test_run_filter_with_c1c2_on_the_card(card, cls):
    key = trandom.PRNGKey(0)
    _, obs = simulate(key, ungm(), 5)
    pf = ParticleFilter(ungm(), 8192, resampler=cls(num_iters=8), ess_threshold=0.5)
    ck.reset_launch_counts()
    est = run_filter(key, pf, obs)
    assert est.is_cuda and est.shape == (5,) and torch.isfinite(est).all()
    assert getattr(ck, f"{cls.name}_step").launches == 5
    r = cls(num_iters=8).build()
    w = torch.rand(4, 8192, device=card)
    keys = trandom.split(key, 4)
    assert torch.equal(r.batch_rows(keys, w).cpu(), r.batch_rows(keys, w.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,max_iters", ((4, 8192, 1), (4, 3072, 24), (4, 8192, 1024),
                                           (3, 3072, 24), (3, 3072, rk.MAX_ITERS),
                                           (16, 1 << 20, 1024), (16, 1 << 20, rk.MAX_ITERS)))
def test_rejection_rows_kernel_matches_plain_version(card, s, n, max_iters):
    """Rows 19-22 on warp chains, bit for bit: max_iters = 1 (the cap binds
    for most lanes, which keep their own index), 24, 1024 (the path's) and
    the wrappers' cap 2^31 - 2 (no lane reaches it; the rounds left are
    counted down, so nothing overflows); subnormal weights; S·N that splits
    unevenly over the grid's warps x REJ_CHUNK (S = 3, N = 3072); at N = 2^20
    a heavy-tailed bank, w = u^20 (21 rounds a lane on average, hundreds
    at most); an all-zero row (sup w = 0: every lane accepts itself at
    round 0) and, where max_iters is finite in practice, a NaN row (no lane
    accepts; each keeps its index)."""
    w, _, state, _, seeds = _inputs(card, s=s, n=n)
    if n == 1 << 20:
        w = w ** 2.5
    w[1] = 0.0
    nan_row = max_iters <= 1024
    if nan_row:
        w[s - 1, 5] = float("nan")
    rk.reset_launch_counts()
    want_anc, want_out = rref.rejection_rows_ref(w, state, seeds, max_iters)
    anc, out = rk.rejection_fused_batch(w, state, seeds, max_iters)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    ids = torch.arange(n, dtype=torch.int32, device=card)
    assert torch.equal(anc[1], ids)
    if nan_row:
        assert torch.equal(anc[s - 1], ids)
    assert torch.equal(rk.rejection_batch(w, seeds, max_iters), want_anc)
    assert torch.equal(rk.rejection(w[0], seeds[0], max_iters), want_anc[0])
    assert torch.equal(rk.rejection_fused(w[0], state[0], seeds[0], max_iters)[1], want_out[0])
    assert [fn.launches for fn in rk.WRAPPERS[:4]] == [1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", (1, 64, rk.MAX_ITERS))
def test_rejection_step_kernel_matches_plain_version(card, max_iters):
    """Rows 23-24, bit for bit, with the cap binding (1), not (64), and at
    the wrappers' cap 2^31 - 2 (no lane reaches it; the rounds left are
    counted down, so nothing overflows)."""
    _, lw, state, _, seeds = _inputs(card)
    rk.reset_launch_counts()
    anc, out, stats = rk.rejection_step_rows(lw, state, seeds, max_iters, 0.5)
    want_anc, want_out, want_stats = rref.rejection_step_rows_ref(lw, state, seeds, max_iters,
                                                                  0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
    # Sums in another order than torch.sum: as the Megopolis step kernel.
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    # sup w = 1 (1/N on the dead row) in the kernel, the literal max here.
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(rk.rejection_step_rows(lw, state, seeds, max_iters, 0.5)[2], stats)
    one = rk.rejection_step(lw[0], state[0], seeds[0], max_iters, 0.5)
    assert torch.equal(one[0], want_anc[0])
    assert (rk.rejection_step_rows.launches, rk.rejection_step.launches) == (2, 1)


def _spike_log_weights(dev, n):
    """Six rows of log-weights for the rejection step: flat at -5 with one
    warp's lanes 0-30 at 0 (they accept their own proposal at once, lane 31
    needs about 1/(e^-5 + 31/N) rounds, hundreds, as does every lane
    elsewhere); flat (ESS 1: the row does not resample); UNGM-like; one
    spike at 0 over -7 (about 1000 rounds a lane, so the default cap binds
    too); dead (-inf: uniform, ESS 1); and flat again."""
    g = torch.Generator().manual_seed(11)
    lw = torch.full((6, n), -5.0)
    lw[0, 64:95] = 0.0
    lw[1] = 0.0
    lw[2] = -0.5 * (torch.rand(n, generator=g) * 12) ** 2
    lw[3] = -7.0
    lw[3, n // 3] = 0.0
    lw[4] = float("-inf")
    lw[5] = 0.0
    state = torch.randn(6, 1, n, generator=g)
    seeds = torch.randint(0, 2**32, (6,), generator=g)
    return lw.to(dev), state.to(dev), seeds


@pytest.mark.cuda
@pytest.mark.parametrize("n", (8192, 3 << 12))
@pytest.mark.parametrize("max_iters", (64, 1024))
def test_rejection_step_kernel_on_a_spike(card, n, max_iters):
    """Row 24 where lanes of one warp differ by hundreds of rounds, with
    rows that resample and rows that do not, the cap binding (64) and the
    default (1024, still reached by a few lanes): the ancestors and states
    bit for bit, and the rounds the plain version counts show the spread."""
    lw, state, seeds = _spike_log_weights(card, n)
    rounds = rref.rejection_rounds_ref(lw, seeds, max_iters, log_weights=True, thr=0.5)
    assert (rounds[0, 64:95] == 0).all() and rounds[0].max() >= min(max_iters, 500)
    assert (rounds[[1, 4, 5]] == -1).all()  # rows that do not resample (ESS 1)
    assert (rounds[3] == max_iters).any()
    anc, out, stats = rk.rejection_step_rows(lw, state, seeds, max_iters, 0.5)
    want_anc, want_out, want_stats = rref.rejection_step_rows_ref(lw, state, seeds, max_iters,
                                                                  0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    for r in (0, 1, 4):
        one = rk.rejection_step(lw[r], state[r], seeds[r], max_iters, 0.5)
        assert torch.equal(one[0], want_anc[r]) and torch.equal(one[1], want_out[r])


@pytest.mark.cuda
def test_run_filter_with_rejection_on_the_card(card):
    key = trandom.PRNGKey(0)
    _, obs = simulate(key, ungm(), 5)
    pf = ParticleFilter(ungm(), 8192, resampler=RejectionSpec(max_iters=64), ess_threshold=0.5)
    rk.reset_launch_counts()
    est = run_filter(key, pf, obs)
    assert est.is_cuda and est.shape == (5,) and torch.isfinite(est).all()
    assert rk.rejection_step.launches == 5
    r = RejectionSpec(max_iters=64).build()
    w = torch.rand(4, 8192, device=card) ** 8
    keys = trandom.split(key, 4)
    assert torch.equal(r.batch_rows(keys, w).cpu(), r.batch_rows(keys, w.cpu()))


def _prefix_weights(dev, n):
    """Four rows: subnormal and zero weights (flat CDF runs), equal weights
    (systematic draws on the CDF's steps), one dominant weight among tiny
    normal ones, and a NaN."""
    g = torch.Generator().manual_seed(1)
    w = torch.rand(4, n, generator=g) ** 8
    w[0, ::7] = 1e-39
    w[0, ::5] = 0.0
    w[1] = 1.0
    w[2] = 2e-38
    w[2, n // 3] = 1.0
    w[3, 5] = float("nan")
    return w.to(dev)


def _scan_rows(dev, s, n):
    """``_prefix_weights``' four rows, then signed values: tiny normals of
    alternating sign (sums below 2^-126, flushed by the adds), infinities of
    both signs, -0.0 throughout, and normal draws."""
    g = torch.Generator().manual_seed(5)
    extra = torch.randn(s - 4, n, generator=g)
    extra[0] = (1.0 + torch.rand(n, generator=g)) * 1.2e-38 * (-1.0) ** torch.arange(n)
    extra[1, 100], extra[1, n - 1] = float("inf"), float("-inf")
    extra[2] = -0.0
    return torch.cat([_prefix_weights("cpu", n), extra]).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", ((8, 1024), (8, 1 << 14), (8, 1 << 20), (16, 1 << 20),
                                 (7, 1 << 22)))
def test_prefix_scan_kernel_matches_plain_version(card, s, n):
    """Row 25: bit for bit, each row's carry restarting at 0, over spans of
    one tile (S = 8, N = 2^20: 8192 tiles on at most 1056 blocks, so
    several), spans across row ends, folds longer than a staged chunk
    (N = 2^22: 4096 tiles a row), and a view 4 bytes off a 16-byte
    boundary (one element at a time); then on grids of 3 and 7 blocks,
    whose spans hold many tiles and cross row ends, in place as the step
    scans."""
    w = _scan_rows(card, s, n)
    pk.reset_launch_counts()
    want = pref.scan_rows_ref(w)
    lib = pk._lib()
    tot = torch.empty(s * (n // 1024), device=card)
    for blocks in (3, 7):
        y = w.clone()
        assert lib.prefix_scan_rows(y.data_ptr(), y.data_ptr(), tot.data_ptr(), s, n, blocks,
                                    0, pk.stream(y)) == 0
        assert torch.equal(y.view(torch.int32), want.view(torch.int32)), blocks
    got = pk.prefix_sum_rows(w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(pk.prefix_sum_rows(w[2:3].contiguous())[0].view(torch.int32),
                       want[2].view(torch.int32))
    assert torch.equal(pk.prefix_sum_rows(w).view(torch.int32), got.view(torch.int32))
    view = torch.empty(s * n + 1, device=card)[1:].view(s, n)
    view.copy_(w)
    assert torch.equal(pk.prefix_sum_rows(view).view(torch.int32), want.view(torch.int32))
    assert pk.prefix_sum_rows.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1 << 14, 1 << 20))
def test_prefix_search_kernels_match_plain_version(card, n):
    """Rows 26-28 on the scanned rows, with draws of every kind."""
    w = _prefix_weights(card, n)
    state = torch.randn(4, 2, n, generator=torch.Generator().manual_seed(2)).to(card)
    c = pref.scan_rows_ref(w)
    g = torch.Generator().manual_seed(3)
    ubase = torch.rand(4, n, generator=g).to(card)
    u0 = torch.rand(4, generator=g).to(card)
    sk.reset_launch_counts()
    for kind in ("multinomial", "systematic", "stratified"):
        u = pref.scaled_draws(kind, c[:, -1], n, ubase, u0)
        side = "right" if pref.side_is_right(kind) else "left"
        want, want_out = pref.search_rows_ref(c, u, side == "right", state)
        assert torch.equal(sk.searchsorted_rows(c, u, side), want)
        anc, out = sk.searchsorted_gather_rows(c, u, state, side)
        assert torch.equal(anc, want) and torch.equal(out, want_out)
        assert torch.equal(sk.searchsorted_rows(c[1:2], u[1:2], side)[0], want[1])
        assert torch.equal(sk.searchsorted_gather_rows(c[:1], u[:1], state[:1], side)[1][0],
                           want_out[0])
    counts, resid, n_det = pref.residual_parts(w, c[:, -1])
    cc, cr = pref.scan_rows_ref(counts), pref.scan_rows_ref(resid)
    u = pref.scaled_draws("residual", cr[:, -1], n, ubase)
    want, want_out = pref.residual_select_rows_ref(cc, cr, u, n_det, state)
    anc, out = sk.residual_select_gather_rows(cc, cr, u, n_det, state)
    assert torch.equal(anc, want) and torch.equal(out, want_out)
    one = sk.residual_select_gather_rows(cc[:1], cr[:1], u[:1], n_det[:1], state[:1])
    assert torch.equal(one[0][0], want[0])
    assert [fn.launches for fn in sk.WRAPPERS] == [6, 6, 2]


def _tree_search_inputs(dev, s, n, seed):
    """Rows of every shape the bisection must follow step by step: a CDF,
    values that are not monotone, a CDF holding NaN (one at the root's
    midpoint), a row of NaN; draws at random over the values' range, on the
    values themselves and rising with i; a state of two planes; and
    residual's count CDF and n_det."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(s, n, generator=g)
    c = torch.cumsum(x.abs(), dim=1)
    c[1] = x[1]
    c[2, n // 2] = float("nan")
    c[2, torch.randint(0, n, (n // 64,), generator=g)] = float("nan")
    c[3] = float("nan")
    top = float(c[0, -1])
    u = torch.rand(s, n, generator=g) * 1.2 * top - 0.1 * top
    u[:, ::5] = c[0, torch.randint(0, n, (n // 5 + 1,), generator=g)][: u[:, ::5].shape[1]]
    u[0] = torch.linspace(-1.0, top + 1.0, n)
    state = torch.randn(s, 2, n, generator=g)
    cc = torch.cumsum(torch.randint(0, 3, (s, n), generator=g).float(), dim=1)
    n_det = torch.tensor([n // 3, 0, n, n // 2])[:s]
    return [t.to(dev) for t in (c, u, state, cc)] + [n_det]


def _search_all(c, u, state, cc, n_det):
    """The three search wrappers on both sides, on either kernel of the
    first two (``rising``), against their plain versions, bit for bit."""
    for side in ("left", "right"):
        want, want_out = pref.search_rows_ref(c, u, side == "right", state)
        for rising in (False, True):
            assert torch.equal(sk.searchsorted_rows(c, u, side, rising), want), side
            anc, out = sk.searchsorted_gather_rows(c, u, state, side, rising)
            assert torch.equal(anc, want) and torch.equal(out, want_out), side
    want, want_out = pref.residual_select_rows_ref(cc, c, u, n_det, state)
    anc, out = sk.residual_select_gather_rows(cc, c, u, n_det, state)
    assert torch.equal(anc, want) and torch.equal(out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1024, 3 << 12, 1 << 14, 1 << 18))
def test_prefix_search_tree_kernels(card, n):
    """Rows 26-28 on trees of 2, 4, 4 and 5 groups of lines (N = 3·2^12
    fills its nodes by replaying the midpoints), and on the kernel of rising
    draws: bit for bit the plain
    version's bisection on a CDF, on values that are not monotone, on a CDF
    holding NaN and on a row of NaN, both sides, index only, with the state
    copy and the residual select.  The library's tree size is
    ``search.tree_floats``, and a smaller scratch is refused."""
    c, u, state, cc, n_det = _tree_search_inputs(card, 4, n, seed=n)
    sk.reset_launch_counts()
    _search_all(c, u, state, cc, n_det)
    assert [fn.launches for fn in sk.WRAPPERS] == [4, 4, 1]
    lib = pk._lib()
    lib.prefix_search_tree_floats.argtypes = [ctypes.c_int]
    lib.prefix_search_tree_floats.restype = ctypes.c_longlong
    assert lib.prefix_search_tree_floats(n) == sk.tree_floats(n)
    anc = torch.empty(4, n, dtype=torch.int32, device=card)
    tree = torch.empty(4 * sk.tree_floats(n), device=card)
    def search(cc_ptr, nd_ptr, tree_ptr, floats, right):
        return lib.prefix_search_rows(c.data_ptr(), cc_ptr, u.data_ptr(), nd_ptr, None,
                                      anc.data_ptr(), None, tree_ptr, floats, 4, n, 1, right,
                                      4, pk.stream(c))

    assert search(None, None, tree.data_ptr(), tree.numel() - 1, 0) != 0
    assert search(None, None, tree.data_ptr(), tree.numel(), 0) == 0
    assert torch.equal(anc, pref.search_rows_ref(c, u, False))
    nd = n_det.to(device=card, dtype=torch.int32)
    # The residual select runs only on the tree kernel: no tree, no launch.
    assert search(cc.data_ptr(), nd.data_ptr(), None, 0, 1) != 0


@pytest.mark.cuda
def test_prefix_search_tree_at_the_largest_row(card):
    """N = 2^22, Path C's largest: a tree of 6 groups, the wrappers bit for
    bit."""
    c, u, state, cc, n_det = _tree_search_inputs(card, 4, 1 << 22, seed=7)
    _search_all(c, u, state, cc, n_det)


def _prefix_step_inputs(dev, kind, s, n):
    """``_inputs``' log-weights (UNGM-like rows, the last dead) with row 1
    holding a NaN (a degenerate row, as the dead one), its state, and the
    draw bases of ``kind``."""
    _, lw, state, _, _ = _inputs(dev, s=s, n=n)
    lw[1, 7] = float("nan")
    g = torch.Generator().manual_seed(4)
    ubase = None if kind == "systematic" else torch.rand(s, n, generator=g).to(dev)
    u0 = torch.rand(s, generator=g).to(dev) if kind == "systematic" else None
    return lw, state, ubase, u0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("multinomial", "systematic", "stratified", "residual"))
@pytest.mark.parametrize("n", (1024, 1 << 14, 1 << 20))
def test_prefix_step_kernel_matches_plain_version(card, kind, n):
    """Row 29: the stats as the other step kernels, the ancestors and
    states bit for bit (the same weights, the same scan, run in place on
    the step's weights; residual's counts and residuals as one bank; the
    random draws through each fired row's tree), on a dead row and a row
    holding NaN (both degenerate), at thresholds 0.5 (those two do not
    fire) and 2 (every row fires, the degenerate ones on the uniform
    CDF)."""
    lw, state, ubase, u0 = _prefix_step_inputs(card, kind, 4, n)
    stk.reset_launch_counts()
    for thr in (0.5, 2.0):
        anc, out, stats = stk.prefix_step_rows(lw, state, ubase, u0, thr, kind)
        want_anc, want_out, want_stats = pref.prefix_step_rows_ref(lw, state, ubase, u0, thr,
                                                                   kind)
        assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
        torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
        assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
        assert bool(stats[:, 2].all()) == (thr > 1)
    again = stk.prefix_step_rows(lw, state, ubase, u0, 2.0, kind)[2]
    assert torch.equal(again.view(torch.int32), stats.view(torch.int32))  # NaN's bits too
    one_args = (lw[:1], state[:1], None if ubase is None else ubase[:1],
                None if u0 is None else u0[:1], 1.0, kind)
    assert torch.equal(stk.prefix_step_rows(*one_args)[0], pref.prefix_step_rows_ref(*one_args)[0])
    assert stk.prefix_step_rows.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("multinomial", "residual"))
@pytest.mark.parametrize("s,n", ((MAX_STEP_ROWS, 1024), (MAX_STEP_ROWS, 1 << 14), (256, 1 << 20)))
def test_prefix_step_kernel_at_the_largest_banks(card, kind, s, n):
    """Row 29 with a search tree a row in its work space: the most rows a
    step admits (4096, trees of 2 and 4 groups), and a bank of 2^20-particle
    rows with 1.2 MB of tree each (300 MB in all), every row fired: the
    ancestors and states bit for bit with the plain version, row by row."""
    lw, state, ubase, u0 = _prefix_step_inputs(card, kind, s, n)
    anc, out, stats = stk.prefix_step_rows(lw, state, ubase, u0, 2.0, kind)
    assert bool(stats[:, 2].all())
    for rows in (slice(0, 4), slice(s // 2, s // 2 + 1), slice(s - 4, s)):
        want_anc, want_out, _ = pref.prefix_step_rows_ref(lw[rows], state[rows], ubase[rows],
                                                          None, 2.0, kind)
        assert torch.equal(anc[rows], want_anc) and torch.equal(out[rows], want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("multinomial", "improved_systematic", "residual"))
def test_run_filter_with_prefix_sum_on_the_card(card, kind):
    key = trandom.PRNGKey(0)
    _, obs = simulate(key, ungm(), 5)
    pf = ParticleFilter(ungm(), 8192, resampler=PrefixSumSpec(kind=kind), ess_threshold=0.5)
    stk.reset_launch_counts()
    est = run_filter(key, pf, obs)
    assert est.is_cuda and est.shape == (5,) and torch.isfinite(est).all()
    assert stk.prefix_step_rows.launches == 5
    r = PrefixSumSpec(kind=kind).build()
    w = torch.rand(4, 8192, device=card) ** 8
    keys = trandom.split(key, 4)
    assert torch.equal(r.batch_rows(keys, w).cpu(), r.batch_rows(keys, w.cpu()))
    p = torch.randn(4, 8192, device=card)
    got = r.apply_rows(keys, w, p)
    want = r.apply_rows(keys, w.cpu(), p.cpu())
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 2048, 3000, 1 << 20, (1 << 23) + 3))
def test_fixture_kernels_match_plain_version(card, n):
    """Rows 30-31; the copy also of views 1-3 elements into their tensor
    (its head, vectors and tail), and its library refuses an output at
    another offset modulo 16 bytes (cudaErrorInvalidValue, 1), which
    ``copy_launch`` never passes."""
    base = torch.randn(n + 3, generator=torch.Generator().manual_seed(0)).to(card)
    x = base[:n]
    fk.reset_launch_counts()
    got = fk.copy_launch(x)
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(got.view(torch.int32), fref.copy_ref(x).view(torch.int32))
    for off in (1, 2, 3):
        view = base[off:off + n]
        assert torch.equal(fk.copy_launch(view).view(torch.int32), view.view(torch.int32))
    assert torch.equal(fk.iota_launch(x), fref.iota_ref(n, card))
    assert fk.copy_launch.launches == 4 and fk.iota_launch.launches == 1
    out = torch.empty(n + 1, device=card)[1:]
    assert fk._lib().fixture_copy(x.data_ptr(), out.data_ptr(), n,
                                  torch.cuda.current_stream().cuda_stream) == 1


@pytest.mark.cuda
def test_resource_tables_are_the_cards(card):
    assert smem.card_drift() == []


def _kernel_instance(event: str):
    m = re.match(r"(?:void )?(\w+(?:<[^()]*>)?)\(", event)
    return None if m is None else m.group(1)


@pytest.mark.cuda
@pytest.mark.parametrize("name,entry", (("megopolis", "step"), ("residual", "call"),
                                        ("metropolis_c2", "apply_rows"),
                                        ("multinomial", "step_rows")))
def test_census_matches_the_profiler(card, name, entry):
    args = contracts.audit_args(device=card)
    runs = []

    @contextlib.contextmanager
    def profiled(rec):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        seen = collections.Counter()
        for e in prof.events():
            k = _kernel_instance(e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and k in smem.KERNELS:
                seen[k] += 1
        runs.append((dict(rec.census), dict(seen)))

    rep = contracts.audit_cell(name, entry, args, around=profiled)
    assert rep.ok, rep.violations
    # A step cell runs on both sides of its flag, and both runs are profiled.
    assert len(runs) == (2 if entry.startswith("step") else 1)
    assert runs[0][0] == dict(rep.census)
    assert all(census == seen for census, seen in runs), runs


@pytest.mark.cuda
def test_selftest_on_the_card(card):
    assert afix.selftest(card) == []


# ------------------------------------------------- compressed planes (§14)
PLANES = (torch.bfloat16, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("n,s,b", RING_CASES)
def test_megopolis_plane_kernels_match_plain_version(card, dtype, n, s, b):
    """The bfloat16 and float16 instances, with their 2 KiB segments and
    8-word grain, across the ring depths: bit for bit (the step's stats to
    the sums' tolerance), the single-population wrappers too."""
    w, lw, state, offsets, seeds = (x.to(dtype) if x.is_floating_point() else x
                                    for x in _ring_inputs(card, n, s, b))
    mk.reset_launch_counts()
    want = ref.megopolis_rows_ref(w, offsets, seeds)
    assert torch.equal(mk.megopolis_rows(w, offsets, seeds), want)
    assert torch.equal(mk.megopolis(w[0], offsets[0], seeds[0]), want[0])
    anc, out = mk.megopolis_fused_rows(w, state, offsets, seeds)
    want_anc, want_out = ref.megopolis_fused_rows_ref(w, state, offsets, seeds)
    assert torch.equal(anc, want_anc) and torch.equal(out.view(torch.int16),
                                                      want_out.view(torch.int16))
    assert out.dtype == dtype and torch.equal(anc, want)
    anc, out, stats = mk.megopolis_step_rows(lw, state, offsets, seeds, 0.5)
    want_anc, want_out, want_stats = ref.megopolis_step_rows_ref(lw, state, offsets, seeds, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    one = mk.megopolis_step(lw[-1], state[-1], offsets[-1], seeds[-1], 0.5)
    assert torch.equal(one[0], want_anc[-1])
    assert (mk.megopolis_rows.launches, mk.megopolis.launches, mk.megopolis_fused_rows.launches,
            mk.megopolis_step_rows.launches, mk.megopolis_step.launches) == (1, 1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("n,s,b", ((3072, 3, 257), (1024 * 7, 16, 9), (1 << 20, 1, 33),
                                   (1 << 20, 16, 32)))
def test_metropolis_plane_kernels_match_plain_version(card, dtype, n, s, b):
    """The bfloat16 and float16 instances (2-byte random reads, weights
    below float16's normal range, a subnormal last tile) against their
    plain versions, bit for bit."""
    w, lw, state, seeds = (x.to(dtype) if x.is_floating_point() else x
                           for x in _redesign_inputs(card, n, s, n + 10 * s + b))
    wrappers = (tk.metropolis_batch, tk.metropolis_fused_batch, tk.metropolis_step_rows)
    _check_rows_and_step(card, wrappers, tref.metropolis_rows_ref, tref.metropolis_step_rows_ref,
                         w, lw, state, (seeds,), b)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", (MegopolisSpec, MetropolisSpec))
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_compressed_specs_on_the_card(card, cls, dtype):
    """A compressed spec's bank entries on the card: the index-only and
    fused ones equal the float32 spec on the quantised inputs, the step
    takes the triggers the CPU takes and gathers its own ancestors'
    quantised particles; particles come back in the caller's dtype."""
    r, r32 = cls(num_iters=16, plane_dtype=dtype).build(), cls(num_iters=16).build()
    w, lw, state, _, _ = _inputs(card, s=3, n=4096)
    p = state.transpose(1, 2).contiguous()
    keys = trandom.split(trandom.PRNGKey(3), 3)
    assert torch.equal(r.batch_rows(keys, w), r32.batch_rows(keys, r.quantise(w)))
    got_p, got_a = r.apply_rows(keys, w, p)
    want_p, want_a = r32.apply_rows(keys, r.quantise(w), r.quantise(p))
    assert got_p.dtype == torch.float32 and torch.equal(got_p, want_p)
    assert torch.equal(got_a, want_a)
    got_p, got_a, stats = r.step_rows(keys, lw, p, 0.5)
    cpu_stats = r.step_rows(keys, lw.cpu(), p.cpu(), 0.5)[2]
    assert torch.equal(stats.resampled.cpu(), cpu_stats.resampled)
    assert got_p.dtype == torch.float32
    assert torch.equal(got_p, torch.gather(r.quantise(p), 1,
                                           got_a.long()[..., None].expand_as(p)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 5, 2048, (1 << 23) + 3))
def test_iota_kernel_on_offset_views(card, n):
    """Row 31 into views 0-3 elements into their tensor: its head, its
    16-byte stores and its tail, bit for bit with the plain version."""
    base = torch.full((n + 3,), -1, dtype=torch.int32, device=card)
    fk.reset_launch_counts()
    for off in (0, 1, 2, 3):
        out = base[off:off + n].view(1, n)
        got = fk.iota_launch(base[:n], out=out)
        assert got.data_ptr() == out.data_ptr() and torch.equal(got, fref.iota_ref(n, card))
    assert fk.iota_launch.launches == 4
    assert int(base[-1]) == n - 1  # the last view's tail


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2",
                                  "rejection", "multinomial", "stratified", "residual"))
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_plane_census_matches_the_profiler(card, name, dtype):
    """A compressed cell launches its float32 budget, and the profiler
    names each launch as the census does (``kernel<..., __nv_bfloat16>``;
    residual's count and residual scans take the float32 scan)."""
    args = contracts.audit_args(device=card)
    for entry in ("apply_rows", "step"):
        # The profiler drops a kernel record now and then (chip_smoke.py's
        # ``witness_census``): a cell it saw short is run once more, and
        # must then be seen exactly.
        for attempt in (0, 1):
            seen = collections.Counter()

            @contextlib.contextmanager
            def profiled(rec):
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    yield
                    torch.cuda.synchronize()
                seen.update(k for k in (_kernel_instance(e.name) for e in prof.events()
                                        if e.device_type == torch.autograd.DeviceType.CUDA)
                            if k in smem.KERNELS)

            rep = contracts.audit_cell(name, entry, args, around=profiled, plane_dtype=dtype)
            assert rep.ok and rep.launches == launch_budget(name, "cuda", entry), rep.violations
            # A step cell runs on both sides of its flag, each run profiled.
            runs = 2 if entry == "step" else 1
            assert all(seen[k] <= c * runs for k, c in rep.census.items()), (seen, rep.census)
            if set(seen) == set(rep.census) and sum(seen.values()) == rep.launches * runs:
                break
        word = {"bfloat16": "__nv_bfloat16", "float16": "__half"}[dtype]
        assert set(seen) == set(rep.census), (seen, rep.census)
        # The searches have an instance per state word alone.
        assert all(word in k or k.endswith(", unsigned short>")
                   or k == "prefix_scan_rows_kernel<float>" for k in seen), seen
        assert sum(seen.values()) == rep.launches * runs


def _planes(dtype, *xs):
    """The float tensors of ``xs`` in the plane dtype, the others as they are."""
    return tuple(x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x for x in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("variant", (1, 2))
@pytest.mark.parametrize("n,s,b", ((3072, 3, 257), (3072, 16, 11), (1024 * 7, 4, 40),
                                   (1 << 20, 1, 32), (1 << 20, 16, 32)))
def test_c1c2_plane_kernels_match_plain_version(card, dtype, variant, n, s, b):
    """Rows 13-18's bfloat16 and float16 instances: 2 KiB partition tiles
    through C2's rings (B = 257 and 40 wrap the bank kernel's ring of 5 x 2
    tiles and the step's of 3 x 2 many times, B = 11 ends on a partial
    group), weights with zeros, subnormals and a subnormal last tile, a
    degenerate row and one that does not fire: bit for bit (the step's
    stats to the sums' tolerance), one launch each."""
    w, lw, state, seeds = _planes(dtype, *_redesign_inputs(card, n, s, 7 * n + s + b))
    parts = _tables(card, variant, s, n, b, seed=b)
    parts[:, 0], parts[:, -1] = 0, n // 1024 - 1
    c = f"metropolis_c{variant}"
    wrappers = tuple(getattr(ck, c + sfx) for sfx in ("_batch", "_fused_batch", "_step_rows"))

    def plain(w_, st, p_, sd, it):
        return tref.metropolis_c1c2_rows_ref(w_, st, p_, sd, it, variant)

    def plain_step(lw_, st, p_, sd, it, thr):
        return tref.metropolis_c1c2_step_rows_ref(lw_, st, p_, sd, it, thr, variant)

    _check_rows_and_step(card, wrappers, plain, plain_step, w, lw, state, (parts, seeds), b)
    one = getattr(ck, c + "_fused")(w[0], state[0], parts[0], seeds[0], b)
    want = plain(w[:1], state[:1], parts[:1], seeds[:1], b)
    assert torch.equal(one[0], want[0][0]) and torch.equal(one[1], want[1][0])
    assert one[1].dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("variant", (1, 2))
def test_c1c2_plane_step_at_the_most_rows(card, dtype, variant):
    """The 2-byte step instances at 4096 rows (C2's ring beside the
    per-row shift and flags, through the opt-in)."""
    n, s, b = 1024, MAX_STEP_ROWS, 5
    _, lw, state, seeds = _planes(dtype, *_redesign_inputs(card, n, s, variant))
    parts = _tables(card, variant, s, n, b, seed=variant)
    c = f"metropolis_c{variant}"
    anc, out, stats = getattr(ck, c + "_step_rows")(lw, state, parts, seeds, b, 0.5)
    want_anc, want_out, want_stats = tref.metropolis_c1c2_step_rows_ref(
        lw, state, parts, seeds, b, 0.5, variant)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("s,n,max_iters", ((4, 8192, 1), (3, 3072, 24), (4, 8192, 1024),
                                           (16, 1 << 20, 1024)))
def test_rejection_plane_kernels_match_plain_version(card, dtype, s, n, max_iters):
    """Rows 19-24's bfloat16 and float16 instances: the rows kernels with
    sup w upcast from the plane words (an all-zero row, a NaN row), the
    step on UNGM-like rows and a dead row (sup w = 1/N rounded to the word),
    bit for bit, one launch each."""
    w, lw, state, _, seeds = _planes(dtype, *_inputs(card, s=s, n=n))
    if n == 1 << 20:
        w = w ** 2.5
    w[1] = 0.0
    w[s - 1, 5] = float("nan")
    rk.reset_launch_counts()
    want_anc, want_out = rref.rejection_rows_ref(w, state, seeds, max_iters)
    anc, out = rk.rejection_fused_batch(w, state, seeds, max_iters)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out) and out.dtype == dtype
    assert torch.equal(rk.rejection_batch(w, seeds, max_iters), want_anc)
    assert torch.equal(rk.rejection(w[0], seeds[0], max_iters), want_anc[0])
    assert torch.equal(rk.rejection_fused(w[0], state[0], seeds[0], max_iters)[1], want_out[0])
    anc, out, stats = rk.rejection_step_rows(lw, state, seeds, max_iters, 0.5)
    want_anc, want_out, want_stats = rref.rejection_step_rows_ref(lw, state, seeds, max_iters,
                                                                  0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    one = rk.rejection_step(lw[0], state[0], seeds[0], max_iters, 0.5)
    assert torch.equal(one[0], want_anc[0])
    assert [fn.launches for fn in rk.WRAPPERS] == [1, 1, 1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("n", (8192, 3 << 12))
def test_rejection_plane_step_on_a_spike(card, dtype, n):
    """Row 24's 2-byte instances where one warp's lanes differ by hundreds
    of rounds, beside rows that do not resample: bit for bit."""
    lw, state, seeds = _planes(dtype, *_spike_log_weights(card, n))
    anc, out, stats = rk.rejection_step_rows(lw, state, seeds, 1024, 0.5)
    want_anc, want_out, want_stats = rref.rejection_step_rows_ref(lw, state, seeds, 1024, 0.5)
    assert torch.equal(stats[:, 2], want_stats[:, 2])
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("s,n", ((8, 1024), (8, 1 << 14), (16, 1 << 20)))
def test_prefix_plane_scan_matches_plain_version(card, dtype, s, n):
    """Row 25's 2-byte instances: the scan reads plane words (8-byte vectors
    where aligned, one by one in a view 2 bytes off) and emits the float32
    CDF of the quantised input, bit for bit."""
    w = _scan_rows(card, s, n).to(dtype)
    pk.reset_launch_counts()
    want = pref.scan_rows_ref(w)
    got = pk.prefix_sum_rows(w)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32),
                       pk.prefix_sum_rows(w.float()).view(torch.int32))
    view = torch.empty(s * n + 1, dtype=dtype, device=card)[1:].view(s, n)
    view.copy_(w)
    assert torch.equal(pk.prefix_sum_rows(view).view(torch.int32), want.view(torch.int32))
    assert pk.prefix_sum_rows.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("n", (1024, 3 << 12, 1 << 18))
def test_prefix_plane_searches_match_plain_version(card, dtype, n):
    """Rows 26-28's 2-byte instances: the float32 CDFs and draws, the state
    copied as plane words, on either search kernel and the residual select,
    bit for bit."""
    c, u, state, cc, n_det = _tree_search_inputs(card, 4, n, seed=n + 1)
    state = state.to(dtype)
    sk.reset_launch_counts()
    _search_all(c, u, state, cc, n_det)
    assert [fn.launches for fn in sk.WRAPPERS] == [4, 4, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PLANES, ids=str)
@pytest.mark.parametrize("kind", ("multinomial", "systematic", "stratified", "residual"))
@pytest.mark.parametrize("n", (1024, 1 << 14, 1 << 20))
def test_prefix_plane_step_matches_plain_version(card, dtype, kind, n):
    """Row 29's 2-byte instances: the prelude's weights as plane words,
    scanned into a float32 CDF of their own (residual's counts and residuals
    as before), at thresholds 0.5 and 2, bit for bit."""
    lw, state, ubase, u0 = _prefix_step_inputs(card, kind, 4, n)
    lw, state = lw.to(dtype), state.to(dtype)
    stk.reset_launch_counts()
    for thr in (0.5, 2.0):
        anc, out, stats = stk.prefix_step_rows(lw, state, ubase, u0, thr, kind)
        want_anc, want_out, want_stats = pref.prefix_step_rows_ref(lw, state, ubase, u0, thr,
                                                                   kind)
        assert torch.equal(stats[:, 2], want_stats[:, 2])
        torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
        assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
        assert out.dtype == dtype
    assert stk.prefix_step_rows.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("make", (
    lambda pd: MetropolisC1Spec(num_iters=16, plane_dtype=pd),
    lambda pd: MetropolisC2Spec(num_iters=16, plane_dtype=pd),
    lambda pd: RejectionSpec(max_iters=256, plane_dtype=pd),
    lambda pd: PrefixSumSpec(kind="multinomial", plane_dtype=pd),
    lambda pd: PrefixSumSpec(kind="improved_systematic", plane_dtype=pd),
    lambda pd: PrefixSumSpec(kind="residual", plane_dtype=pd),
), ids=("c1", "c2", "rejection", "multinomial", "improved_systematic", "residual"))
def test_compressed_specs_of_every_family_on_the_card(card, make, dtype):
    """The compressed specs of C1, C2, rejection and the prefix-sum kinds on
    the card: the index-only and fused bank entries equal the float32 spec
    on the quantised inputs, the step takes the triggers the CPU takes and
    gathers its own ancestors' quantised particles; particles come back in
    the caller's dtype."""
    r, r32 = make(dtype).build(), make("float32").build()
    w, lw, state, _, _ = _inputs(card, s=3, n=4096)
    p = state.transpose(1, 2).contiguous()
    keys = trandom.split(trandom.PRNGKey(3), 3)
    assert torch.equal(r.batch_rows(keys, w), r32.batch_rows(keys, r.quantise(w)))
    got_p, got_a = r.apply_rows(keys, w, p)
    want_p, want_a = r32.apply_rows(keys, r.quantise(w), r.quantise(p))
    assert got_p.dtype == torch.float32 and torch.equal(got_p, want_p)
    assert torch.equal(got_a, want_a)
    got_p, got_a, stats = r.step_rows(keys, lw, p, 0.5)
    cpu_stats = r.step_rows(keys, lw.cpu(), p.cpu(), 0.5)[2]
    assert torch.equal(stats.resampled.cpu(), cpu_stats.resampled)
    assert got_p.dtype == torch.float32
    assert torch.equal(got_p, torch.gather(r.quantise(p), 1,
                                           got_a.long()[..., None].expand_as(p)))


# ---------------------------------------------------------- slice 14
@pytest.mark.cuda
@pytest.mark.parametrize("plane_dtype", ("float32", "bfloat16"))
def test_reference_backend_on_the_card_matches_the_cpu(card, plane_dtype):
    """The reference backend's torch ops on CUDA tensors: every family's
    ``__call__`` and ``batch`` bit for bit with the same calls on the CPU."""
    from repro_torch.core.spec import list_resamplers, spec_for_backend

    g = torch.Generator().manual_seed(1)
    w = torch.rand(2, 1 << 14, generator=g) ** 4
    key = trandom.PRNGKey(5)
    for name in list_resamplers():
        r = spec_for_backend(name, "reference", num_iters=8, plane_dtype=plane_dtype).build()
        assert torch.equal(r(key, w[0].to(card)).cpu(), r(key, w[0])), name
        assert torch.equal(r.batch(key, w.to(card)).cpu(), r.batch(key, w)), name


@pytest.mark.cuda
@pytest.mark.parametrize("plane_dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("name", ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2",
                                  "rejection", "multinomial", "improved_systematic",
                                  "residual"))
def test_guard_recover_on_the_card(card, name, plane_dtype):
    """``guard='recover'`` on a bank with collapsed rows: the recovered rows
    equal the plain versions' bit for bit, the clean rows to the step's
    mismatch bound (the card's ``exp`` against the CPU's, ROADMAP Queue C
    item 19), clean rows equal ``'off'``'s on the card bit for bit, and the
    port kernels launched are ``'off'``'s."""
    from repro_torch.core.spec import spec_for_backend
    from repro_torch.kernels.common import observe_launches

    g = torch.Generator().manual_seed(2)
    s, n = 4, 1 << 14
    lw = torch.randn(s, n, generator=g) * 3.0
    lw[1] = float("-inf")
    lw[2, 3] = float("nan")
    p = torch.randn(s, n, generator=g)
    keys = trandom.split(trandom.PRNGKey(6), s)
    outs, census = {}, {}
    for guard in ("off", "recover"):
        r = spec_for_backend(name, "cuda", num_iters=16, max_iters=64, plane_dtype=plane_dtype,
                             guard=guard).build()
        log = []

        class Obs:
            def launched(self, kernel, wrapper, args, out):
                log.append(kernel)

        with observe_launches(Obs()):
            outs[guard] = r.step_rows(keys, lw.to(card), p.to(card), 2.0)
        census[guard] = collections.Counter(log)
        want = r.step_rows(keys, lw, p, 2.0)
        got = outs[guard]
        if guard == "recover":
            rows = [1, 2]
            assert torch.equal(got[1][rows].cpu(), want[1][rows])
            assert torch.equal(got[0][rows].cpu().float().view(torch.int32),
                               want[0][rows].float().view(torch.int32))
            share = (got[1].cpu() != want[1]).double().mean().item()
            print(f"{name}@{plane_dtype}: card vs plain ancestor mismatch share {share}")
            assert share <= 1e-3
            assert bool(torch.isfinite(got[0]).all())
            assert got[2].degenerate.cpu().tolist() == [False, True, True, False]
    assert census["off"] == census["recover"]
    clean = [0, 3]
    for a, b in zip(outs["off"][:2], outs["recover"][:2]):
        assert torch.equal(a[clean], b[clean])


@pytest.mark.cuda
def test_gamma_weights_on_the_card(card):
    from repro_torch.core.weightgen import GAMMA_ALPHA_GRID, gamma_weights

    for alpha in GAMMA_ALPHA_GRID:
        got = gamma_weights(trandom.PRNGKey(0), 1 << 16, alpha, device=card)
        want = gamma_weights(trandom.PRNGKey(0), 1 << 16, alpha, device="cpu")
        assert got.device.type == "cuda" and bool((got > 0).all())
        rel = ((got.cpu().double() - want.double()).abs() / want.double()).max().item()
        share = (got.cpu() == want).double().mean().item()
        print(f"alpha {alpha}: card vs CPU bit-equal share {share:.4f}, max rel {rel:.2e}")
        assert share > 0.5
        scipy_stats = pytest.importorskip("scipy.stats")
        p = scipy_stats.kstest(got.cpu().double().numpy(), scipy_stats.gamma(alpha).cdf).pvalue
        assert p > 1e-3, p


@pytest.mark.cuda
@pytest.mark.parametrize("s, n", (
    (1, 1 << 20), (2, 1 << 20), (4, 1 << 20), (16, 1 << 20),  # the AIS schedule's shapes
    (2, 1 << 22),  # 512 KiB a warp unit
    (4096, 64), (65535, 8),  # more units than the co-resident grid; MAX_ROWS
    (8, 65536), (3, 1000), (7, 1001), (2, 3),
    (3, 4 * 1024 * 3 + 1), (5, 4 * 1024 * 5 - 1)))  # ragged N = 4·1024·k ± 1
def test_logsumexp_rows_kernel_matches_plain_version(card, s, n):
    """The AIS schedule's row reduction: bit for bit with its plain version,
    a bank row with the same row alone (the order follows N, never S nor the
    grid), on 16-byte rows and on rows the kernel reads one lane at a time.
    Above 64 rows, eight rows alone and the bank reversed stand for every
    row alone."""
    from repro_torch.kernels.reduce import reduce as lk
    from repro_torch.kernels.reduce import ref as lref

    g = torch.Generator(device=card).manual_seed(s * 7 + n)
    x = 5.0 * torch.randn(s, n, generator=g, device=card)
    lk.reset_launch_counts()
    got = lk.logsumexp_rows(x)
    assert lk.logsumexp_rows.launches == 1
    assert torch.equal(got.view(torch.int32), lref.logsumexp_rows_ref(x).view(torch.int32))
    alone = range(s) if s <= 64 else sorted({0, 1, 2, s // 3, s // 2, s - 3, s - 2, s - 1})
    for i in alone:
        assert torch.equal(lk.logsumexp_rows(x[i:i + 1].contiguous()).view(torch.int32),
                           got[i:i + 1].view(torch.int32))
    if s > 64:
        assert torch.equal(lk.logsumexp_rows(x.flip(0).contiguous()).flip(0).view(torch.int32),
                           got.view(torch.int32))


@pytest.mark.cuda
def test_logsumexp_rows_kernel_keeps_non_finite_rows(card):
    from repro_torch.kernels.reduce import reduce as lk
    from repro_torch.kernels.reduce import ref as lref

    x = torch.randn(5, 4096, device=card)
    x[0] = float("-inf")
    x[1, 5] = float("inf")
    x[2, 7] = float("nan")
    x[3, :100] = -1e-40  # subnormal: flushed by the kernel and the plain version
    x[4] = -1e30
    got, want = lk.logsumexp_rows(x), lref.logsumexp_rows_ref(x)
    assert torch.equal(got.nan_to_num(), want.nan_to_num()) and torch.isnan(got[2])
    assert got[0] == float("-inf") and got[1] == float("inf")

    # A NaN or +inf in warp 31's chains alone (chains 992-1023: quads
    # 992 + 1024k, ...), so only the last of a row's 32 warp units sees it;
    # an all -inf row between finite rows of one bank.
    lk.reset_launch_counts()
    n = 1 << 20
    x = torch.randn(5, n, device=card)
    x[0, 4 * (1000 + 1024 * 77) + 2] = float("nan")
    x[1, 4 * (1023 + 1024 * 255) + 3] = float("inf")
    x[2] = float("-inf")
    x[3, 4 * 992] = 80.0  # the row's max, in warp 31's first chain
    got, want = lk.logsumexp_rows(x), lref.logsumexp_rows_ref(x)
    assert lk.logsumexp_rows.launches == 1
    assert torch.isnan(got[0]) and got[1] == float("inf") and got[2] == float("-inf")
    assert torch.equal(got[1:].view(torch.int32), want[1:].view(torch.int32))
    for i in (3, 4):
        assert torch.equal(lk.logsumexp_rows(x[i:i + 1].contiguous()).view(torch.int32),
                           got[i:i + 1].view(torch.int32))


# ----------------------------------------- int32 state: SMC decoding's tokens
VOCAB = 151936


def _token_state(card, s, d, n):
    """Token ids 0 .. VOCAB - 1 in order over ``[S, D, N]`` int32 (each one a
    float32 subnormal as a bit pattern, 0 a zero), then the int32 extremes."""
    state = torch.remainder(torch.arange(s * d * n, dtype=torch.int64), VOCAB)
    state = state.to(torch.int32).reshape(s, d, n)
    state[0, 0, :2] = torch.tensor([-(2**31), 2**31 - 1], dtype=torch.int32)
    return state.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", (6.0, 0.0), ids=("resample", "keep"))
def test_megopolis_int32_state_comes_back_bit_for_bit(card, spread):
    """Every Megopolis wrapper that copies state, on int32 tokens beside
    float32 weights, at both branches of the step: the same ancestors as the
    plain version and every token id moved unchanged."""
    s, d, n = 2, 19, 8192  # 311296 ids: 0 .. 151935 twice over
    w, lw, _, offsets, seeds = _inputs(card, s=s, n=n)
    lw = lw[:s].clone()
    lw[:] = lw[0] * spread / 6.0  # spread 0: ESS/N = 1, no row fires
    state = _token_state(card, s, d, n)
    mk.reset_launch_counts()
    anc, out = mk.megopolis_fused_rows(w[:s].contiguous(), state, offsets[:s], seeds[:s])
    want_anc, want_out = ref.megopolis_fused_rows_ref(w[:s], state, offsets[:s], seeds[:s])
    assert out.dtype == torch.int32 and torch.equal(anc, want_anc) and torch.equal(out, want_out)
    anc1, out1 = mk.megopolis_fused(w[0].contiguous(), state[0], offsets[0], seeds[0])
    assert torch.equal(anc1, want_anc[0]) and torch.equal(out1, want_out[0])
    got = mk.megopolis_step_rows(lw, state, offsets[:s], seeds[:s], 0.5)
    want = ref.megopolis_step_rows_ref(lw, state, offsets[:s], seeds[:s], 0.5)
    assert bool(got[2][:, 2].any()) == (spread > 0)
    assert got[1].dtype == torch.int32
    assert torch.equal(got[2][:, 2], want[2][:, 2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = mk.megopolis_step(lw[1].contiguous(), state[1], offsets[1], seeds[1], 0.5)
    assert torch.equal(one[0], want[0][1]) and torch.equal(one[1], want[1][1])
    assert torch.equal(got[1], torch.gather(state, 2, got[0].long().unsqueeze(1).expand_as(state)))
    assert (mk.megopolis_fused_rows.launches, mk.megopolis_fused.launches,
            mk.megopolis_step_rows.launches, mk.megopolis_step.launches) == (1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_megopolis_int32_state_beside_a_2byte_plane_comes_back_bit_for_bit(card, dtype):
    """The 2-byte instances copy a 4-byte state as its own words: the same
    ancestors and tokens as the plain version, bit for bit, at both branches
    of the step."""
    s, d, n = 2, 19, 8192
    w, lw, _, offsets, seeds = _inputs(card, s=s, n=n)
    w, lw = w[:s].to(dtype).contiguous(), lw[:s].to(dtype).contiguous()
    lw[1] = 0.0  # row 1: ESS/N = 1, the step keeps its particles
    state = _token_state(card, s, d, n)
    mk.reset_launch_counts()
    anc, out = mk.megopolis_fused_rows(w, state, offsets[:s], seeds[:s])
    want_anc, want_out = ref.megopolis_fused_rows_ref(w, state, offsets[:s], seeds[:s])
    assert out.dtype == torch.int32 and torch.equal(anc, want_anc) and torch.equal(out, want_out)
    got = mk.megopolis_step_rows(lw, state, offsets[:s], seeds[:s], 0.5)
    want = ref.megopolis_step_rows_ref(lw, state, offsets[:s], seeds[:s], 0.5)
    assert got[2][:, 2].tolist() == [1.0, 0.0] == want[2][:, 2].tolist()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1], torch.gather(state, 2, got[0].long().unsqueeze(1).expand_as(state)))
    assert mk.megopolis_fused_rows.launches == mk.megopolis_step_rows.launches == 1


#: Every family's spec, the prefix-sum family at each kind: each entry that
#: copies state (apply, apply_rows, step, step_rows) on int32 tokens.
INT_STATE_SPECS = {
    "megopolis": lambda dt: MegopolisSpec(plane_dtype=dt),
    "metropolis": lambda dt: MetropolisSpec(num_iters=16, plane_dtype=dt),
    "metropolis_c1": lambda dt: MetropolisC1Spec(num_iters=16, plane_dtype=dt),
    "metropolis_c2": lambda dt: MetropolisC2Spec(num_iters=16, plane_dtype=dt),
    "rejection": lambda dt: RejectionSpec(max_iters=1024, plane_dtype=dt),
    **{kind: (lambda k: lambda dt: PrefixSumSpec(kind=k, plane_dtype=dt))(kind)
       for kind in ("multinomial", "systematic", "improved_systematic", "stratified",
                    "residual")},
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("family", sorted(INT_STATE_SPECS))
def test_every_family_copies_int32_state_bit_for_bit(card, family, dtype):
    """ROADMAP Queue C item 23: every family's kernels take an int32 state
    beside every plane dtype and move it unchanged: token ids 0 .. 151935
    and the int32 extremes, the same ancestors and tokens as the plain
    version on the CPU, one population and a bank of two, both branches of
    the step."""
    s, d, n = 2, 19, 8192
    w, lw, _, _, _ = _inputs(card, s=s, n=n)
    w, lw = w[:s].contiguous(), lw[:s].contiguous()
    lw[1] = 0.0  # row 1: ESS/N = 1, the step keeps its particles
    tokens = _token_state(card, s, d, n).transpose(1, 2).contiguous()  # [S, N, D]
    r = INT_STATE_SPECS[family](dtype).build()
    keys = trandom.split(trandom.PRNGKey(5), s)

    def both(fn, *args):
        got = fn(*args)
        want = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        return got, want

    for got, want in (both(r.apply, keys[0], w[0], tokens[0]),
                      both(r.apply_rows, keys, w, tokens)):
        assert got[0].dtype == torch.int32
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    for got, want in (both(r.step, keys[1], lw[1], tokens[1], 0.5),
                      both(r.step_rows, keys, lw, tokens, 0.5)):
        assert got[0].dtype == torch.int32
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    anc = got[1].long()
    assert torch.equal(got[0], torch.gather(tokens, 1, anc.unsqueeze(-1).expand_as(tokens)))
    assert torch.equal(got[1][1].cpu(), torch.arange(n, dtype=got[1].dtype))


@pytest.mark.cuda
def test_serve_once_on_the_card_at_smoke_size(card):
    """``serve_once`` with its defaults' resampler (a registry name: the
    kernels) at the kernels' tile: one step launch a token, resamples fired,
    every token in the vocabulary, finite log-weights."""
    from repro_torch.launch.serve import DECODE_PARTICLES, serve_once

    mk.reset_launch_counts()
    out = serve_once("qwen3-0.6b", num_particles=DECODE_PARTICLES, prompt_len=4, new_tokens=8,
                     target_temp=0.5)
    tokens = out["tokens"]
    assert tokens.is_cuda and tokens.shape == (DECODE_PARTICLES, 8)
    assert bool(((tokens >= 0) & (tokens < 512)).all())
    assert bool(torch.isfinite(out["log_weights"]).all()) and out["num_resamples"] >= 1
    assert mk.megopolis_step.launches == 8


#: One training step of a smoke config, card against CPU: the loss and the
#: gradients' norm add in other orders (cuBLAS, MKL).  The AdamW step moves a
#: weight by u = -lr·(g/(|g| + eps) + wd·p), about ±lr.  Where the CPU
#: gradient is at least TRAIN_GRAD_FLOOR, far above its rounding, both
#: devices' g/(|g| + eps) are the same ±1 and the updates differ by the
#: rounding of p + u: within TRAIN_UPDATE_ATOL (lr/300; a skipped or
#: misscaled update is off by about lr), on at least TRAIN_TIGHT_SHARE of
#: the weights.  Below the floor the two devices' gradient bits can differ
#: in sign, so the updates differ by at most 2·lr.
TRAIN_CPU_RTOL = 1e-5
TRAIN_LR = 3e-4
TRAIN_GRAD_FLOOR = 1e-5
TRAIN_UPDATE_ATOL = 1e-6
TRAIN_TIGHT_SHARE = 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("qwen3-0.6b", "mamba2-1.3b", "dbrx-132b"))
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """``launch.train.make_step`` of the smoke config from the same params
    and batch on both devices, with no port kernel launched on the card."""
    import dataclasses

    from repro_torch.checkpoint import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.convert import _map_tree
    from repro_torch.data import SyntheticLMStream
    from repro_torch.kernels.reduce import reduce as lk
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, value_and_grad

    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32, remat=False)
    params = init_params(trandom.PRNGKey(0), cfg, device="cpu")
    host = {"params": params, "opt": adamw_init(params)}
    batch = SyntheticLMStream(cfg.vocab_size, 64, 4).batch(0, device="cpu")
    step = train.make_step(cfg, AdamWConfig(peak_lr=TRAIN_LR, total_steps=8, warmup_steps=1))
    want, wm = step(host, batch)
    _, grads = value_and_grad(lambda p, b: train.loss_fn(p, cfg, b))(params, batch)
    modules = (mk, tk, ck, rk, pk, sk, stk, fk, lk)
    for m in modules:
        m.reset_launch_counts()
    got, gm = step(_map_tree(lambda t: t.cuda(), host), _map_tree(lambda t: t.cuda(), batch))
    assert not any(w.launches for m in modules for w in m.WRAPPERS)
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=TRAIN_CPU_RTOL)
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]), rel=TRAIN_CPU_RTOL)
    n_tight = n = 0
    for p, a, b, g in zip(*(tree_leaves(t) for t in (params, got["params"], want["params"],
                                                      grads))):
        assert a.is_cuda
        p = p.double()
        diff = ((a.cpu().double() - p) - (b.double() - p)).abs()
        tight = g.abs() >= TRAIN_GRAD_FLOOR
        assert float(diff.masked_fill(~tight, 0).max()) <= TRAIN_UPDATE_ATOL
        assert float(diff.masked_fill(tight, 0).max()) <= 2 * TRAIN_LR
        n_tight += int(tight.sum())
        n += tight.numel()
    assert n_tight >= TRAIN_TIGHT_SHARE * n


@pytest.mark.cuda
def test_train_resume_on_the_card_is_bit_for_bit(card, tmp_path, monkeypatch):
    """A run killed after its checkpoint at step 4, then resumed, equals the
    straight 8 steps bit for bit under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's backward
    adds with atomics otherwise)."""
    import json

    from repro_torch.checkpoint import tree_leaves
    from repro_torch.launch import train

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    base = dict(arch="qwen3-0.6b", steps=8, smoke=True)

    def deterministic(**kw):
        torch.use_deterministic_algorithms(True)
        try:
            return train.run(train.TrainRun(**base, **kw))
        finally:
            torch.use_deterministic_algorithms(False)

    full = deterministic(ckpt_dir=str(tmp_path / "a"), ckpt_every=100)

    class Killed(Exception):
        pass

    save_async = train.CheckpointManager.save_async

    def save_then_die(self, step, tree, *, extra=None):
        save_async(self, step, tree, extra=extra)
        self.wait()
        raise Killed

    with monkeypatch.context() as m:
        m.setattr(train.CheckpointManager, "save_async", save_then_die)
        with pytest.raises(Killed):
            deterministic(ckpt_dir=str(tmp_path / "b"), ckpt_every=4)
    first = [json.loads(line)["loss"] for line in open(tmp_path / "b" / "heartbeat.json")]
    second = deterministic(ckpt_dir=str(tmp_path / "b"), ckpt_every=100, resume=True)
    assert first + second["losses"] == full["losses"]
    for a, b in zip(tree_leaves(second["state"]), tree_leaves(full["state"])):
        assert a.is_cuda and torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()
