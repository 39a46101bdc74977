"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the filter's default device.  They skip without a card
(this file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``)."""

import pytest
import torch

from repro_torch import random as trandom
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
from repro_torch.kernels.megopolis import megopolis as mk
from repro_torch.kernels.megopolis import ref
from repro_torch.kernels.metropolis import metropolis as tk
from repro_torch.kernels.metropolis import ref as tref
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
