"""The port's contract checks (``repro_torch.analysis``, plain versions on the
CPU) against the JAX package's analyzer.

* Rows 30-31: the fixture kernels' plain versions equal the JAX fixtures'
  Pallas kernels in interpret mode (``_copy_launch``, ``hbm_roundtrip``),
  bit for bit, on seeded numpy inputs.
* The matrix: each of the 80 (family, entry) cells on ``cuda`` runs the
  launches the JAX package declares (``launch_budget``) and that JAX's own
  census counts in its ``pallas_interpret`` trace, with no ancestor round
  trip and no RNG finding; each of the 80 on ``reference`` launches no port
  kernel (rejection's data-dependent rounds waived), and the 'auto'
  reference paths are free of RNG findings but Megopolis's waived one.  The JAX analyzer's taint and RNG passes are blind under jax
  0.9.0 (ROADMAP Queue C item 6), so those two are held to the contract,
  not to JAX's output; its census of the matrix does work.
* Each fixture is caught by exactly the pass of the "expected pass" column
  of JAX's ``FIXTURES`` (``vmem`` there, ``smem`` here) and by no other;
  pass 6 is quiet on real cells and fires both halves on ``leaky_telemetry``;
  pass 7 (guard neutrality) is quiet on every (family, backend) step cell
  and fires all three checks on ``leaky_guard``.
* The §2.4 transaction table equals JAX's on the same seed.
* ``python -m repro_torch.analysis --selftest`` and ``--check --device cpu``
  exit 0; ``--backends`` and ``--no-resilience`` select the backend axis and
  pass 7.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import walker as jwalker
from repro.analysis.contracts import trace_cell
from repro.analysis.fixtures import FIXTURES as JAX_FIXTURES
from repro.analysis.fixtures import _copy_launch
from repro.analysis.fixtures import hbm_roundtrip as jax_hbm_roundtrip
from repro.analysis.report import transaction_report as jax_transaction_report
from repro.core import spec as jspec
from repro_torch import random as trandom
from repro_torch.analysis import contracts, fixtures, guards, report, rng, smem, telemetry
from repro_torch.analysis.__main__ import main
from repro_torch.ais.schedule import ADAPTIVE_LAUNCHES
from repro_torch.analysis.consumers import (
    AUDIT_STEPS,
    AUDIT_TEMPS,
    AUTO_FAMILIES,
    DECODE_STEPS,
    MEGOPOLIS_AUTO_WAIVER,
    audit_consumers,
    auto_reference_rng,
)
from repro_torch.analysis.walker import count_launches, launch_census
from repro_torch.core import spec
from repro_torch.kernels.common import kernel_wrapper, observe_launches
from repro_torch.kernels.fixtures import fixtures as fk
from repro_torch.kernels.fixtures import ref as fref
from repro_torch.kernels.megopolis import megopolis as mk
from repro_torch.kernels.metropolis import c1c2 as ck
from repro_torch.kernels.metropolis import metropolis as tk
from repro_torch.kernels.prefix_sum import prefix_sum as pk
from repro_torch.kernels.prefix_sum import search as sk
from repro_torch.kernels.prefix_sum import step as stk
from repro_torch.kernels.rejection import rejection as rk

REPO = Path(__file__).resolve().parent.parent
N = contracts.AUDIT_N
CELLS = [(name, entry) for name, _, entry in spec.contract_cells(backends=("cuda",))]
MODULES = (mk, tk, ck, rk, pk, sk, stk, fk)


@pytest.fixture(scope="module")
def args():
    return contracts.audit_args(device="cpu")


# ---------------------------------------------------------- rows 30-31
@pytest.mark.parametrize("n", (N, 3000))
def test_copy_plain_version_matches_jax_kernel(n):
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    x[::5] = np.float32(1e-40)  # subnormals are copied as bits, never flushed
    want = np.asarray(_copy_launch(jnp.asarray(x)))
    got = fk.copy_launch(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert fref.copy_ref(torch.from_numpy(x)).data_ptr() != torch.from_numpy(x).data_ptr()


def test_hbm_roundtrip_matches_jax_fixture():
    g = np.random.default_rng(1)
    w = g.random(N, dtype=np.float32)
    state = g.standard_normal((N, 4)).astype(np.float32)
    want = np.asarray(jax_hbm_roundtrip(jnp.asarray(w), jnp.asarray(state)))
    got = fixtures.hbm_roundtrip(torch.from_numpy(w), torch.from_numpy(state)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    idx = fk.iota_launch(torch.from_numpy(w))
    assert idx.dtype == torch.int32 and idx.shape == (1, N)
    assert torch.equal(idx[0], torch.arange(N, dtype=torch.int32))


def test_fixture_wrappers_count_no_launch_on_cpu():
    fk.reset_launch_counts()
    fixtures.extra_launch(torch.zeros(N))
    fk.iota_launch(torch.zeros(N))
    assert fk.copy_launch.launches == 0 and fk.iota_launch.launches == 0


# ---------------------------------------------------------- the matrix
def test_budgets_and_families_are_the_jax_packages():
    assert spec.ENTRY_POINTS == jspec.ENTRY_POINTS
    assert spec.list_resamplers() == list(jspec.list_resamplers())
    assert spec.LAUNCH_BUDGETS == jspec.LAUNCH_BUDGETS
    with pytest.raises(KeyError, match="did you mean 'megopolis'"):
        spec.launch_budget("megopolys", "cuda", "call")


@pytest.mark.parametrize("name,entry", CELLS, ids=[f"{f}/{e}" for f, e in CELLS])
def test_matrix_cell_census_and_contract(name, entry, args):
    rep = contracts.audit_cell(name, entry, args)
    jax_count = jwalker.count_pallas_calls(trace_cell(name, "pallas_interpret", entry))
    budget = spec.launch_budget(name, "cuda", entry)
    assert budget == jspec.launch_budget(name, "pallas", entry) == jax_count
    assert rep.launches == budget, rep.census
    assert rep.tainted_gathers == 0 and not rep.rng_findings and not rep.smem_over
    assert rep.ok and not rep.waived, rep.violations


def test_wrappers_count_no_launch_on_cpu_under_the_census(args):
    for m in MODULES:
        m.reset_launch_counts()
    for name in ("megopolis", "residual"):
        for entry in spec.ENTRY_POINTS:
            assert contracts.audit_cell(name, entry, args).launches > 0
    assert all(w.launches == 0 for m in MODULES for w in m.WRAPPERS)


def test_census_counts_a_wrapper_inside_another_once():
    @kernel_wrapper("inner_kernel")
    def inner(x):
        return x + 1

    @kernel_wrapper("outer_kernel")
    def outer(x):
        return inner(x) * 2

    _, rec = contracts.record(lambda: outer(torch.zeros(4)))
    assert launch_census(rec.launches) == {"outer_kernel": 1}
    assert count_launches(rec.launches) == 1


def test_taint_flags_kernel_derived_gather_only():
    state = torch.arange(N * 4, dtype=torch.float32).reshape(N, 4)
    w = torch.full((N,), 1.0 / N)
    r = spec.MegopolisSpec(num_iters=4).build()
    key = trandom.PRNGKey(3)

    def bad():
        anc = r(key, w)
        return state[anc.long()]  # the ancestors come back as gather indices

    def clean():
        anc = r(key, w)
        idx = torch.arange(N)  # indices not derived from a kernel: allowed
        return state.index_select(0, idx), anc.sort().values[1:] != anc.sort().values[:-1]

    def handed_on():  # a tainted index passed to a second wrapper is an argument
        return fk.copy_launch(r(key, w).float())

    assert contracts.record(bad)[1].roundtrips
    assert not contracts.record(clean)[1].roundtrips
    assert not contracts.record(handed_on)[1].roundtrips


# ---------------------------------------------------------- RNG discipline
def _rng(program):
    return rng.rng_findings(contracts.record(program, taint=False)[1].keys)


def test_rng_key_reuse_and_clean_split():
    key = trandom.PRNGKey(0)

    def clean():
        k1, k2 = trandom.split(key)
        return trandom.uniform(k1, (4,)) + trandom.normal(k2, (4,))

    assert [f.code for f in _rng(lambda: trandom.uniform(key, (4,)) +
                                 trandom.normal(key, (4,)))] == ["key-reuse"]
    assert not _rng(clean)


def test_rng_fold_in_distinct_data_is_idiom():
    key = trandom.PRNGKey(0)

    def folds(a, b):
        return trandom.uniform(trandom.fold_in(key, a), (4,)) + trandom.uniform(
            trandom.fold_in(key, b), (4,))

    assert not _rng(lambda: folds(0, 1))
    # fold_in(key, 7) twice, and so the one key it gives drawn from twice
    assert {f.code for f in _rng(lambda: folds(7, 7))} == {"key-reuse"}


def test_rng_loop_invariant_key():
    key = trandom.PRNGKey(0)

    def loop():
        return [trandom.uniform(key, (4,)) for _ in range(3)]

    def chained():
        k = key
        out = []
        for _ in range(3):
            k, sub = trandom.split(k)
            out.append(trandom.uniform(sub, (4,)))
        return out

    assert [f.code for f in _rng(loop)] == ["loop-invariant-key"]
    assert not _rng(chained)


def test_rng_record_is_scoped_to_one_program():
    one = lambda: trandom.uniform(trandom.PRNGKey(0), (4,))  # noqa: E731
    assert not _rng(one) and not _rng(one)
    assert [f.code for f in _rng(lambda: (one(), one()))] == ["key-reuse"]
    assert [f.code for f in _rng(lambda: [one() for _ in range(2)])] == ["loop-invariant-key"]
    two = lambda: (trandom.uniform(trandom.PRNGKey(0), (4,)),  # noqa: E731
                   trandom.normal(trandom.PRNGKey(0), (4,)))
    assert [f.code for f in _rng(two)] == ["key-reuse"]


def test_rng_sees_the_kernel_seed():
    """``key_to_seed`` consumes its key: two Metropolis launches seeded from
    one key draw the same ancestor stream, and that is reuse."""
    key, w = trandom.PRNGKey(0), torch.full((N,), 1.0 / N)
    r = contracts.cell_resampler("metropolis")
    assert [f.code for f in _rng(lambda: (r(key, w), r.apply(key, w, torch.zeros(N, 1))))] \
        == ["key-reuse"]
    assert not _rng(lambda: [r(k, w) for k in trandom.split(key)])
    log = contracts.record(lambda: r(key, w), taint=False)[1].keys
    assert [e.kind for e in log.events] == ["seed"]


def test_step_cells_consume_the_key_alike_on_both_sides(args):
    """The §12 rule: each family's step consumes its key whether or not the
    row resamples."""
    for name in spec.list_resamplers():
        r = contracts.cell_resampler(name)
        sides = []
        for fire in (True, False):
            out, rec = contracts.record(contracts.entry_callable(r, "step", args, fire))
            sides.append(rec.keys)
            assert bool(out[2].resampled) is fire
        assert sides[0].events and not rng.branch_findings(*sides), name


# ---------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", list(fixtures.FIXTURES))
def test_fixture_caught_by_its_pass(name):
    _, expected = fixtures.FIXTURES[name]
    assert expected == {"vmem": "smem"}.get(JAX_FIXTURES[name][2], JAX_FIXTURES[name][2])
    rep = fixtures.FIXTURES[name][0]("cpu")
    assert not rep.ok
    fired = {p for p, mark in fixtures.PASS_MARKS.items()
             if any(mark in v for v in rep.violations)}
    assert fired == {expected}, rep.violations


def test_waiver_records_its_reason_in_place_of_the_violation():
    key, w = trandom.PRNGKey(0), torch.zeros(N)
    waiver = contracts.Waiver("key-reuse", "random_bits, random_bits", "by design, for a test")
    rep = contracts.audit_program("fixture:reused_key:waived", lambda: fixtures.reused_key(key, w),
                                  contracts.Contract(max_launches=0, waivers=(waiver,)))
    assert rep.ok and not rep.rng_findings
    assert [x["reason"] for x in rep.waived] == ["by design, for a test"]


def test_oversized_fixture_is_priced_not_launched():
    fk.reset_launch_counts()
    fp = fixtures.oversized_vmem()
    assert fp.smem == 4 << 23 and fp.per_sm == 0
    rep = fixtures.FIXTURES["oversized_vmem"][0]("cpu")
    assert rep.launches == 0 and len(rep.smem_over) == 1


def test_largest_shapes_within_the_cards_limits():
    reps = list(contracts.audit_large_n())
    assert len(reps) == sum(len(smem.largest_shapes(k)) for k in smem.KERNELS)
    assert all(r.ok for r in reps), [r.violations for r in reps if not r.ok]
    step = smem.price("megopolis_step_rows_kernel<float>", 4096, 1 << 19)
    assert step.dynamic_smem == 8 * 4096 and step.blocks <= step.per_sm * 132


@pytest.mark.parametrize("rows, n, blocks", ((1, 1 << 20, 32), (2, 1 << 20, 64),
                                             (8, 1 << 20, 256), (16, 1 << 20, 264),
                                             (65535, 8, 264)))
def test_row_reduction_grid_is_co_resident_units(rows, n, blocks):
    """The row reduction's launch: blocks of 8 warps with their ring (4
    chunks of 16 rounds of 512 bytes) and the warps' maxima in static
    shared memory, on a co-resident grid of at most a block a (row, warp)
    unit, whatever N."""
    res = smem.KERNELS["logsumexp_rows_kernel"]
    assert (res.grid, res.threads, res.static_smem, res.cooperative) == (
        "coop_units", 256, 4 * 16 * 512 + 8 * 4, True)
    fp = smem.price("logsumexp_rows_kernel", rows, n)
    assert fp.per_sm == smem.blocks_per_sm(res.registers, res.static_smem) == 2
    assert fp.blocks == blocks == min(rows * smem.UNITS, fp.per_sm * 132)
    assert (fp.threads, fp.dynamic_smem, fp.grid_y) == (256, 0, 1)
    assert not smem.smem_findings([fp])


def test_fixture_selftest_clean():
    assert fixtures.selftest("cpu") == []


# ---------------------------------------------------------- pass 6
@pytest.mark.parametrize("name", spec.list_resamplers())
def test_telemetry_neutral(name):
    rep = telemetry.audit_telemetry_cell(name, "cpu")
    assert rep["ok"], rep["violations"]
    assert rep["launches_on"] == rep["launches_off"] == telemetry.NEUTRALITY_STEPS * \
        spec.launch_budget(name, "cuda", "step")


def test_leaky_telemetry_fires_both_halves():
    rep = telemetry.compare_runs("fixture:leaky_telemetry", *fixtures.leaky_telemetry("cpu"))
    assert not rep["ok"] and len(rep["violations"]) == 2
    assert (rep["launches_off"], rep["launches_on"]) == (0, 1)
    assert not rep["estimates_match"]


# ---------------------------------------------------------- consumers
def test_consumers_one_launch_per_step():
    reps = {r.cell: r for r in audit_consumers(device="cpu")}
    assert set(reps) == {"pf.step", "pf.step_conditional", "pf.run_filter",
                         "pf.run_filter_bank", "ais.run_smc_sampler",
                         "ais.run_smc_sampler_bank", "ais.adaptive_mala", "smc.decode"}
    for name, r in reps.items():
        assert r.ok, r.violations
        assert not r.rng_findings
        if name == "smc.decode":
            # One step launch a token at DECODE_PARTICLES; the ancestor-indexed
            # gather of every KV leaf (2 layers x K and V) each step is the one
            # round trip a consumer's contract allows.
            assert r.launches == DECODE_STEPS
            assert r.census == {"megopolis_step_rows_kernel<float>": DECODE_STEPS}
            assert r.tainted_gathers == DECODE_STEPS * 2 * 2
            continue
        assert not r.tainted_gathers
        if name == "ais.adaptive_mala":  # the step, and the CESS bisection's reductions
            assert r.launches == AUDIT_TEMPS * (1 + ADAPTIVE_LAUNCHES)
            assert r.census["logsumexp_rows_kernel"] == AUDIT_TEMPS * ADAPTIVE_LAUNCHES
        elif name.startswith("ais."):
            assert r.launches == AUDIT_TEMPS
        else:
            assert r.launches == (AUDIT_STEPS if name.startswith("pf.run") else 1)


# ---------------------------------------------------------- transactions
@pytest.mark.parametrize("word_bytes", (4, 2))
def test_transaction_report_matches_jax(word_bytes):
    assert report.transaction_report(word_bytes=word_bytes) == \
        jax_transaction_report(word_bytes=word_bytes)


# ---------------------------------------------------------- the CLI
def test_cli_selftest_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--selftest",
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selftest: OK" in out.stdout


def test_cli_check_cpu_exits_zero(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert main(["--check", "--device", "cpu", "--json", str(path)]) == 0
    text = capsys.readouterr().out
    # 80 (family, entry) cells on each backend, cuda and reference
    assert "matrix on cpu: 160 cells, 0 violation(s)" in text and text.rstrip().endswith("OK")
    assert path.stat().st_size > 0


def test_cli_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        main(["--selftest"])


#: The checks' public entry points, called with their default device.
DEFAULT_DEVICE_CALLS = {
    "audit_args": lambda: contracts.audit_args(),
    "audit_matrix": lambda: contracts.audit_matrix(),
    "build_report": lambda: report.build_report(),
    "audit_consumers": lambda: audit_consumers(),
    "audit_telemetry_cell": lambda: telemetry.audit_telemetry_cell("megopolis"),
    "audit_telemetry": lambda: telemetry.audit_telemetry(),
    "leaky_telemetry": lambda: fixtures.leaky_telemetry(),
    "telemetry_selftest": lambda: fixtures.telemetry_selftest(),
    "audit_fixtures": lambda: fixtures.audit_fixtures(),
    "selftest": lambda: fixtures.selftest(),
}


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The package's device rule: with no device given an entry point asks
    for the card, and without one it raises before any work (no CPU
    fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        DEFAULT_DEVICE_CALLS[entry]()


def test_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


# ---------------------------------------------------------- backends
REF_CELLS = [(name, entry) for name, _, entry in spec.contract_cells(backends=("reference",))]


@pytest.mark.parametrize("name", spec.list_resamplers())
def test_reference_cells_launch_no_port_kernel(name, args):
    """The reference backend's cells: no port kernel, no round trip, no
    unwaived RNG finding (rejection's data-dependent rounds are waived)."""
    for entry in spec.ENTRY_POINTS:
        rep = contracts.audit_cell(name, entry, args, backend="reference")
        assert rep.cell == f"{name}/reference/{entry}"
        assert rep.launches == rep.max_launches == 0 and not rep.census
        assert rep.ok, rep.violations
        waived = {w["reason"] for w in rep.waived}
        assert waived <= {contracts.REJECTION_ROUNDS_WAIVER.reason}
        assert bool(waived) == (name == "rejection" and entry.startswith("step"))
    assert len(REF_CELLS) == 80


def test_auto_reference_rng_waives_megopolis_only():
    got = {cell: (kept, waived) for cell, kept, waived in auto_reference_rng(device="cpu")}
    assert set(got) == {f"{n}/reference/auto" for n in AUTO_FAMILIES}
    assert all(not kept for kept, _ in got.values())
    assert [len(w) for _, w in got.values()] == [1, 0, 0, 0]
    assert got["megopolis/reference/auto"][1][0]["reason"] == MEGOPOLIS_AUTO_WAIVER.reason


# ---------------------------------------------------------- pass 7
@pytest.mark.parametrize("backend", spec.BACKENDS)
@pytest.mark.parametrize("name", spec.list_resamplers())
def test_guard_pass_clean(name, backend):
    rep = guards.audit_guard_cell(name, backend, device="cpu")
    assert rep["ok"], rep["violations"]
    assert rep["flag_program_match"] and rep["clean_bit_identical"]
    assert rep["degenerate_recovered"]
    assert rep["launches_off"] == rep["launches_recover"] == \
        spec.launch_budget(name, backend, "step")


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_guard_pass_clean_compressed(dtype):
    reps = list(guards.audit_guards(("megopolis", "residual"), plane_dtypes=(dtype,),
                                    device="cpu"))
    assert [r["cell"] for r in reps] == [f"{n}/{b}/step@{dtype}" for n in ("megopolis",
                                                                             "residual")
                                         for b in spec.BACKENDS]
    assert all(r["ok"] for r in reps), [r["violations"] for r in reps]


def test_leaky_guard_fires_all_three():
    rep = guards.compare_guard_runs("fixture:leaky_guard", *fixtures.leaky_guard(), device="cpu")
    assert not rep["ok"] and len(rep["violations"]) == 3
    assert not rep["flag_program_match"]
    assert (rep["launches_off"], rep["launches_recover"]) == (0, 1)
    assert not rep["degenerate_recovered"]
    assert fixtures.guard_selftest("cpu") == []


def test_cli_backends_and_pass_7(capsys):
    assert main(["--check", "--selftest", "--device", "cpu", "--backends", "reference",
                 "--families", "megopolis,systematic", "--no-large-n",
                 "--no-transactions"]) == 0
    text = capsys.readouterr().out
    assert "selftest: OK" in text
    assert "matrix on cpu: 16 cells, 0 violation(s)" in text
    assert "guard neutrality: 2 cells, 0 violation(s)" in text
    assert "auto-reference rng: 0 violation(s)" in text
    assert main(["--check", "--device", "cpu", "--families", "megopolis", "--no-consumers",
                 "--no-large-n", "--no-transactions", "--no-telemetry",
                 "--no-resilience"]) == 0
    text = capsys.readouterr().out
    assert "matrix on cpu: 16 cells" in text and "guard neutrality" not in text
