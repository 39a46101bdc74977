"""Card-only tests of the port: the CUDA kernels against their plain
versions (Megopolis, with its rings of segment copies across ring depths,
bank sizes, boundary offsets and the most rows a step admits, and its refusal
of misaligned weights;
Metropolis, Metropolis-C1/C2, rejection, the prefix-sum
kinds, the contract checks' two fixture kernels), the filter's default
device, and the contract checks on the card (the resource tables are the
card's, the census equals the profiler's count, the selftest passes).  They skip without a card
(this file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``)."""

import collections
import contextlib
import re
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
RING_STAGES = sorted({int(d) for d in re.findall(r"#define \w+_STAGES (\d+)", (
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
@pytest.mark.parametrize("n,max_iters", ((8192, 1), (3072, 24), (8192, 1024)))
def test_rejection_rows_kernel_matches_plain_version(card, n, max_iters):
    """max_iters = 1 (the cap binds for most lanes, which keep their own
    index), 24, and 1024 (more rounds than one chunk of prefixes); subnormal
    weights and a NaN row (no lane accepts)."""
    w, _, state, _, seeds = _inputs(card, n=n)
    w[3, 5] = float("nan")
    rk.reset_launch_counts()
    want_anc, want_out = rref.rejection_rows_ref(w, state, seeds, max_iters)
    anc, out = rk.rejection_fused_batch(w, state, seeds, max_iters)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(anc[3].cpu(), torch.arange(n, dtype=torch.int32))
    assert torch.equal(rk.rejection_batch(w, seeds, max_iters), want_anc)
    assert torch.equal(rk.rejection(w[2], seeds[2], max_iters), want_anc[2])
    assert torch.equal(rk.rejection_fused(w[2], state[2], seeds[2], max_iters)[1], want_out[2])
    assert [fn.launches for fn in rk.WRAPPERS[:4]] == [1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", (1, 64))
def test_rejection_step_kernel_matches_plain_version(card, max_iters):
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1 << 14, 1 << 20))
def test_prefix_scan_kernel_matches_plain_version(card, n):
    """Row 25: bit for bit, each row's carry restarting at 0."""
    w = _prefix_weights(card, n)
    pk.reset_launch_counts()
    want = pref.scan_rows_ref(w)
    got = pk.prefix_sum_rows(w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(pk.prefix_sum_rows(w[2:3].contiguous())[0].view(torch.int32),
                       want[2].view(torch.int32))
    assert torch.equal(pk.prefix_sum_rows(w).view(torch.int32), got.view(torch.int32))
    assert pk.prefix_sum_rows.launches == 3


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("multinomial", "systematic", "stratified", "residual"))
@pytest.mark.parametrize("n", (1 << 14, 1 << 20))
def test_prefix_step_kernel_matches_plain_version(card, kind, n):
    """Row 29: the stats as the other step kernels, the ancestors and
    states bit for bit (the same weights, the same scan)."""
    _, lw, state, _, _ = _inputs(card, n=n)
    g = torch.Generator().manual_seed(4)
    ubase = None if kind == "systematic" else torch.rand(4, n, generator=g).to(card)
    u0 = torch.rand(4, generator=g).to(card) if kind == "systematic" else None
    stk.reset_launch_counts()
    anc, out, stats = stk.prefix_step_rows(lw, state, ubase, u0, 0.5, kind)
    want_anc, want_out, want_stats = pref.prefix_step_rows_ref(lw, state, ubase, u0, 0.5, kind)
    assert torch.equal(stats[:, 2], want_stats[:, 2])  # the same triggers
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.equal(anc, want_anc) and torch.equal(out, want_out)
    assert torch.equal(stk.prefix_step_rows(lw, state, ubase, u0, 0.5, kind)[2], stats)
    one_args = (lw[:1], state[:1], None if ubase is None else ubase[:1],
                None if u0 is None else u0[:1], 1.0, kind)
    assert torch.equal(stk.prefix_step_rows(*one_args)[0], pref.prefix_step_rows_ref(*one_args)[0])
    assert stk.prefix_step_rows.launches == 3


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
@pytest.mark.parametrize("n", (2048, 3000, 1 << 20))
def test_fixture_kernels_match_plain_version(card, n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(card)
    fk.reset_launch_counts()
    got = fk.copy_launch(x)
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(got.view(torch.int32), fref.copy_ref(x).view(torch.int32))
    assert torch.equal(fk.iota_launch(x), fref.iota_ref(n, card))
    assert fk.copy_launch.launches == 1 and fk.iota_launch.launches == 1


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
