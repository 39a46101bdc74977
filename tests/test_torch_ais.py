"""The port's AIS sampler (``repro_torch.ais``) on its own, on the CPU.

The quality gate of ``tests/test_ais.py``: ``run_smc_sampler`` recovers the
ANALYTIC logZ of the closed-form targets within rtol 0.1 / atol 0.1 for
the four families of ``benchmarks/ais_bench.py``, on the ``cuda`` specs
(their kernels' plain versions here) and on ``reference``, at float32 and
bfloat16 planes.  Then the §4 bank contract (row ``b`` bit for bit the
single call with ``split(key, S)[b]``), the schedules' properties, the
moves' invariance, telemetry neutrality and the argument checks.  The
parity with the JAX package is ``test_torch_ais_parity.py``'s.
"""

import pytest
import torch

from repro_torch import random as trandom
from repro_torch.ais import (
    SMCSamplerConfig,
    Target,
    banana,
    conditional_ess,
    correlated_gaussian,
    gaussian_family,
    gaussian_mixture,
    gaussian_theta,
    geometric_schedule,
    isotropic_gaussian,
    logistic_regression,
    mala,
    next_temperature,
    random_walk_metropolis,
    run_smc_sampler,
    run_smc_sampler_bank,
)
from repro_torch.analysis.contracts import record
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec, spec_for_backend

# The kernels' tile: the cuda specs need N % 1024 == 0.
N = 1024
FAMILIES = ("megopolis", "metropolis", "rejection", "systematic")
CPU = "cpu"


def _assert_same(got: dict, want: dict, what: str):
    for name, leaf in want.items():
        assert torch.equal(got[name], leaf), f"{what} diverged on {name!r}"


# ----------------------------------------------------------- logZ quality gate

@pytest.mark.parametrize("backend", ("reference", "cuda"))
@pytest.mark.parametrize("family", FAMILIES)
def test_logz_recovers_analytic_truth(family, backend):
    temps = 12 if backend == "reference" else 8
    cfg = SMCSamplerConfig(num_particles=N, num_temps=temps,
                           resampler=spec_for_backend(family, backend))
    for target in (isotropic_gaussian(dim=2, device=CPU), gaussian_mixture(device=CPU)):
        out = run_smc_sampler(trandom.PRNGKey(0), target, cfg, device=CPU)
        assert float(out["log_z"]) == pytest.approx(target.log_z, rel=0.1, abs=0.1), \
            f"{family}/{backend} missed logZ on {target.name}"
        assert float(out["betas"][-1]) == 1.0
        assert out["particles"].shape == (N, target.dim)
        assert torch.isfinite(out["particles"]).all()


@pytest.mark.parametrize("backend", ("reference", "cuda"))
@pytest.mark.parametrize("family", FAMILIES)
def test_logz_recovers_analytic_truth_bf16_planes(family, backend):
    temps = 12 if backend == "reference" else 8
    cfg = SMCSamplerConfig(
        num_particles=N, num_temps=temps,
        resampler=spec_for_backend(family, backend, plane_dtype="bfloat16"))
    target = isotropic_gaussian(dim=2, device=CPU)
    out = run_smc_sampler(trandom.PRNGKey(0), target, cfg, device=CPU)
    assert float(out["log_z"]) == pytest.approx(target.log_z, rel=0.1, abs=0.1)
    assert out["particles"].dtype == torch.float32
    assert torch.isfinite(out["particles"]).all()


@pytest.mark.parametrize("make", (banana, correlated_gaussian))
def test_logz_on_banana_and_correlated(make):
    cfg = SMCSamplerConfig(num_particles=N, num_temps=16, resampler="systematic")
    target = make(device=CPU)
    out = run_smc_sampler(trandom.PRNGKey(1), target, cfg, device=CPU)
    assert float(out["log_z"]) == pytest.approx(target.log_z, rel=0.1, abs=0.15)


@pytest.mark.parametrize("kw", ({"schedule": "adaptive"}, {"move": "mala"}),
                         ids=("adaptive", "mala"))
def test_adaptive_schedule_and_mala_recover_logz(kw):
    target = isotropic_gaussian(dim=2, device=CPU)
    cfg = SMCSamplerConfig(num_particles=N, num_temps=16, resampler="systematic", **kw)
    out = run_smc_sampler(trandom.PRNGKey(2), target, cfg, device=CPU)
    assert float(out["log_z"]) == pytest.approx(target.log_z, rel=0.1, abs=0.1)
    assert float(out["betas"][-1]) == 1.0
    assert torch.all(out["betas"][1:] >= out["betas"][:-1])


def test_adaptive_mala_on_the_cuda_spec_recovers_logz():
    target = gaussian_mixture(device=CPU)
    cfg = SMCSamplerConfig(num_particles=N, num_temps=12, resampler=MegopolisSpec(num_iters=16),
                           schedule="adaptive", move="mala")
    out = run_smc_sampler(trandom.PRNGKey(3), target, cfg, device=CPU)
    assert float(out["log_z"]) == pytest.approx(target.log_z, rel=0.1, abs=0.1)
    assert float(out["betas"][-1]) == 1.0


def test_logistic_regression_target_runs():
    target = logistic_regression(num_data=32, dim=3, device=CPU)
    assert target.log_z is None
    cfg = SMCSamplerConfig(num_particles=256, num_temps=10,
                           resampler=spec_for_backend("systematic", "reference"))
    out = run_smc_sampler(trandom.PRNGKey(3), target, cfg, device=CPU)
    assert torch.isfinite(out["log_z"])
    assert out["particles"].shape == (256, 3)
    assert torch.isfinite(out["particles"]).all()


# ------------------------------------------------------- bank bit-identity (§4)

def _thetas(num_s: int):
    scenarios = [gaussian_theta(mean=0.5 * s, sigma=1.0 + 0.25 * s, device=CPU)
                 for s in range(num_s)]
    return {name: torch.stack([th[name] for th in scenarios]) for name in scenarios[0]}


@pytest.mark.parametrize("schedule", ("geometric", "adaptive"))
def test_bank_rows_bit_identical_to_single(schedule):
    fam = gaussian_family(dim=2, device=CPU)
    thetas = _thetas(3)
    cfg = SMCSamplerConfig(num_particles=256, num_temps=8,
                           resampler=spec_for_backend("megopolis", "reference"),
                           schedule=schedule)
    key = trandom.PRNGKey(7)
    bank = run_smc_sampler_bank(key, fam, cfg, thetas=thetas, device=CPU)
    for b, k in enumerate(trandom.split(key, 3)):
        theta = {name: leaf[b] for name, leaf in thetas.items()}
        single = run_smc_sampler(k, fam, cfg, theta=theta, device=CPU)
        _assert_same({name: leaf[b] for name, leaf in bank.items()}, single, f"bank row {b}")
    assert bank["betas"].shape == bank["ess"].shape == bank["accept"].shape == (3, 8)
    assert bank["log_z"].shape == bank["num_resamples"].shape == (3,)


@pytest.mark.parametrize("kw", ({}, {"schedule": "adaptive", "move": "mala"}),
                         ids=("geometric_rwm", "adaptive_mala"))
def test_bank_iid_repeats_bit_identical_on_cuda_spec(kw):
    target = isotropic_gaussian(dim=2, device=CPU)
    cfg = SMCSamplerConfig(num_particles=N, num_temps=6, resampler=MegopolisSpec(num_iters=16),
                           **kw)
    key = trandom.PRNGKey(11)
    bank = run_smc_sampler_bank(key, target, cfg, num_scenarios=2, device=CPU)
    single = run_smc_sampler(trandom.split(key, 2)[1], target, cfg, device=CPU)
    _assert_same({name: leaf[1] for name, leaf in bank.items()}, single, "bank row 1")


def test_bank_argument_validation():
    target = isotropic_gaussian(dim=2, device=CPU)
    cfg = SMCSamplerConfig(num_particles=64, num_temps=2, resampler="systematic")
    with pytest.raises(ValueError, match="thetas.*or.*num_scenarios"):
        run_smc_sampler_bank(trandom.PRNGKey(0), target, cfg, device=CPU)
    with pytest.raises(ValueError, match="disagrees"):
        run_smc_sampler_bank(trandom.PRNGKey(0), gaussian_family(device=CPU), cfg,
                             thetas=_thetas(2), num_scenarios=3, device=CPU)


# ------------------------------------------------------------ config and entries

def test_sampler_config_validation():
    with pytest.raises(ValueError, match="did you mean 'adaptive'"):
        SMCSamplerConfig(num_particles=8, schedule="adaptve")
    with pytest.raises(ValueError, match="did you mean 'mala'"):
        SMCSamplerConfig(num_particles=8, move="malla")
    with pytest.raises(ValueError, match="ess_threshold"):
        SMCSamplerConfig(num_particles=8, ess_threshold=0.0)
    with pytest.raises(ValueError, match="num_temps"):
        SMCSamplerConfig(num_particles=8, num_temps=0)
    with pytest.raises(ValueError, match="num_particles"):
        SMCSamplerConfig(num_particles=0)
    with pytest.raises(ValueError, match="target_cess"):
        SMCSamplerConfig(num_particles=8, target_cess=1.0)
    with pytest.raises(ValueError, match="num_move_steps"):
        SMCSamplerConfig(num_particles=8, num_move_steps=0)
    spec = MetropolisSpec(num_iters=4)
    assert SMCSamplerConfig(num_particles=8, resampler=spec).resampler_spec() is spec
    assert SMCSamplerConfig(num_particles=8, resampler="megopolis",
                            num_iters=9).resampler_spec().num_iters == 9
    named = SMCSamplerConfig(num_particles=8, resampler="systematic").resampler_spec()
    assert named.name == "systematic" and named.backend == "cuda"
    assert SMCSamplerConfig(num_particles=8).resolved_target_accept() == 0.234
    assert SMCSamplerConfig(num_particles=8, move="mala").resolved_target_accept() == 0.574
    assert SMCSamplerConfig(num_particles=8, target_accept=0.3).resolved_target_accept() == 0.3


@pytest.mark.parametrize("bank", (False, True), ids=("single", "bank"))
def test_checkpoint_and_foreign_target_raise_before_any_work(bank):
    cfg = SMCSamplerConfig(num_particles=N, num_temps=2)
    key = trandom.PRNGKey(0)
    if not bank:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A, item 7"):
            run_smc_sampler(key, isotropic_gaussian(device=CPU), cfg, checkpoint=object(),
                            device=CPU)

    def never(*args):
        raise AssertionError("the target was called")

    foreign = Target(dim=2, log_base=never, sample_base=never, log_target=never,
                     name="elsewhere", device=torch.device("cuda"))
    run = ((lambda: run_smc_sampler_bank(key, foreign, cfg, num_scenarios=2, device=CPU))
           if bank else (lambda: run_smc_sampler(key, foreign, cfg, device=CPU)))
    with pytest.raises(ValueError, match="built on cuda"):
        run()


def test_entries_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        isotropic_gaussian()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        geometric_schedule(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gaussian_theta(0.0)
    cfg = SMCSamplerConfig(num_particles=N, num_temps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_smc_sampler(trandom.PRNGKey(0), isotropic_gaussian(device=CPU), cfg)


def test_targets_broadcast_over_a_scenario_axis():
    """The callables take ``x[S, N, d]`` as S rows of ``x[N, d]``, bit for bit;
    the theta family takes ``[S, 1, d]`` / ``[S, 1]`` leaves."""
    x = 2.0 * trandom.normal(trandom.PRNGKey(5), (3, 64, 2))
    for target in (isotropic_gaussian(device=CPU), gaussian_mixture(device=CPU),
                   banana(device=CPU)):
        for fn in (target.log_base, target.log_target):
            bank = fn(x)
            for s in range(3):
                assert torch.equal(bank[s], fn(x[s])), target.name
    fam, thetas = gaussian_family(device=CPU), _thetas(3)
    laid = {"mean": thetas["mean"].reshape(3, 1, 2), "sigma": thetas["sigma"].reshape(3, 1)}
    bank = fam.log_target(x, laid)
    for s in range(3):
        theta = {name: leaf[s] for name, leaf in thetas.items()}
        assert torch.equal(bank[s], fam.log_target(x[s], theta))
    assert torch.allclose(fam.log_z_fn(thetas), torch.log(2 * torch.pi * thetas["sigma"] ** 2))


# ----------------------------------------------------------------- schedules

def test_geometric_schedule_shape_and_endpoint():
    betas = geometric_schedule(16, beta_min=1e-2, device=CPU)
    assert betas.shape == (16,) and betas.dtype == torch.float32
    assert torch.all(betas[1:] > betas[:-1])
    assert float(betas[-1]) == 1.0
    assert float(betas[0]) == pytest.approx(1e-2 ** (1 - 1 / 16))
    with pytest.raises(ValueError, match="num_temps"):
        geometric_schedule(0, device=CPU)
    with pytest.raises(ValueError, match="beta_min"):
        geometric_schedule(8, beta_min=1.5, device=CPU)


def test_conditional_ess_is_n_at_zero_step():
    log_w = torch.tensor([0.0, -50.0, -50.0, -50.0])
    assert float(conditional_ess(log_w, torch.zeros(4))) == pytest.approx(4.0)
    bank = torch.stack([log_w, torch.zeros(4)])
    assert torch.allclose(conditional_ess(bank, torch.zeros(2, 4)), torch.full((2,), 4.0))


def test_next_temperature_bank_rows_equal_single_rows():
    """A bank's bisection holds converged rows, so each row ends where its
    own call does."""
    k = trandom.PRNGKey(9)
    delta = torch.stack([s * trandom.normal(trandom.fold_in(k, s), (256,))
                         for s in (0.5, 4.0, 16.0)])
    log_w = 0.5 * trandom.normal(trandom.fold_in(k, 7), (3, 256))
    beta_prev = torch.tensor([0.0, 0.3, 0.9])
    bank = next_temperature(log_w, delta, beta_prev, 0.9)
    for s in range(3):
        assert torch.equal(bank[s], next_temperature(log_w[s], delta[s], beta_prev[s], 0.9))


def _check_adaptive_ladder(seed: int, scale: float, target: float):
    """For a random tilt/weight profile the bisection ladder is strictly
    increasing, reaches exactly 1.0, and every intermediate step realises a
    conditional ESS within tolerance of the target fraction."""
    k = trandom.PRNGKey(seed)
    n = 256
    delta = scale * trandom.normal(k, (n,))
    log_w = 0.5 * trandom.normal(trandom.fold_in(k, 1), (n,))
    beta = 0.0
    for _ in range(500):
        nxt = float(next_temperature(log_w, delta, beta, target))
        assert nxt > beta, "schedule must be strictly increasing"
        assert nxt <= 1.0
        cess = float(conditional_ess(log_w, (nxt - beta) * delta)) / n
        assert cess >= target - 1e-3
        if nxt < 1.0:
            assert cess <= target + 0.1
        beta = nxt
        if beta == 1.0:
            break
    assert beta == 1.0, "schedule must reach the target temperature"


try:
    from hypothesis import given, settings, strategies as st

    @given(seed=st.integers(0, 2**30), scale=st.floats(0.1, 16.0),
           target=st.sampled_from([0.75, 0.9, 0.95]))
    @settings(max_examples=25, deadline=None)
    def test_adaptive_temperatures_increase_and_hit_target_cess(seed, scale, target):
        _check_adaptive_ladder(seed, scale, target)

except ImportError:
    @pytest.mark.parametrize("seed,scale,target",
                             [(0, 0.1, 0.9), (1, 4.0, 0.75), (2, 16.0, 0.95),
                              (3, 8.0, 0.9)])
    def test_adaptive_temperatures_increase_and_hit_target_cess(seed, scale, target):
        _check_adaptive_ladder(seed, scale, target)


# ------------------------------------------------------------------ move kernels

@pytest.mark.parametrize("move", (random_walk_metropolis, mala), ids=("rwm", "mala"))
def test_moves_preserve_gaussian_invariant_distribution(move):
    """A chain of sweeps against a standard normal keeps its first and
    second moments (the kernels are π-invariant MH corrections)."""
    def log_prob(x):
        return -0.5 * torch.square(x).sum(dim=-1)

    x0 = trandom.normal(trandom.PRNGKey(0), (2048, 2))
    x, accept = move(trandom.PRNGKey(1), x0, log_prob, torch.tensor(0.8), 20)
    assert 0.05 < float(accept) <= 1.0
    assert abs(float(x.mean())) < 0.1
    assert abs(float(x.std()) - 1.0) < 0.1


@pytest.mark.parametrize("move", (random_walk_metropolis, mala), ids=("rwm", "mala"))
def test_moves_bank_rows_equal_single_rows(move):
    def log_prob(x):
        return -0.5 * torch.square(x - 1.0).sum(dim=-1)

    keys = trandom.split(trandom.PRNGKey(4), 3)
    x0 = trandom.normal(trandom.PRNGKey(5), (3, 512, 2))
    sizes = torch.tensor([0.3, 0.8, 1.5])
    xs, accepts = move(keys, x0, log_prob, sizes, 3)
    for s in range(3):
        x, accept = move(keys[s], x0[s], log_prob, sizes[s], 3)
        assert torch.equal(xs[s], x) and torch.equal(accepts[s], accept)


# ------------------------------------------------------------------- telemetry

@pytest.mark.parametrize("bank", (False, True), ids=("single", "bank"))
def test_telemetry_is_neutral(bank):
    """Telemetry on and off: the same census of port kernel launches and a
    bit-identical result; the record's fields have the result's layout."""
    target = gaussian_mixture(device=CPU)
    cfg = SMCSamplerConfig(num_particles=N, num_temps=4, resampler=MegopolisSpec(num_iters=16),
                           schedule="adaptive")
    key = trandom.PRNGKey(13)

    def run(flag):
        if bank:
            return run_smc_sampler_bank(key, target, cfg, num_scenarios=2, telemetry=flag,
                                        device=CPU)
        return run_smc_sampler(key, target, cfg, telemetry=flag, device=CPU)

    off, rec_off = record(lambda: run(False), taint=False)
    (on, tel), rec_on = record(lambda: run(True), taint=False)
    assert rec_on.census == rec_off.census
    assert sum(rec_off.census.values()) == 4
    _assert_same(on, off, "telemetry on")
    layout = (2, 4) if bank else (4,)
    assert torch.equal(tel.betas, off["betas"]) and torch.equal(tel.accept, off["accept"])
    for field in tel.steps:
        assert field.shape == layout
    assert torch.equal(tel.steps.ess_norm, off["ess"])
    assert torch.equal((tel.steps.resampled > 0).sum(dim=-1).to(torch.int32),
                       off["num_resamples"])
