"""The port's resilience layer (DESIGN.md §16) on the CPU, mirroring the JAX
package's ``tests/test_resilience.py`` (its taxonomy, fallback and
checkpoint sections), and the port's checkpointed runs against the JAX
package's runs.

* The taxonomy, ``classify_backend_error`` and the ladder: ``cuda`` →
  ``reference``; a rung whose probe is refused (an injected
  ``KernelLaunchError`` at the kernel's launch) emits exactly one
  ``backend_demotion`` event, and the demoted resampler equals
  ``backend="reference"`` bit for bit; ``build()`` never demotes.
* ``repro_torch.checkpoint``: save, restore onto a template's device and
  dtype, retention, and no partial snapshot ever visible.
* ``checkpointed_scan`` equals the monolithic loop; ``run_filter``,
  ``run_smc_sampler`` and ``run_smc_sampler_bank`` killed by ``fail_after``
  and resumed equal the uninterrupted run bit for bit on every leaf, and
  stay within the whole-run tolerances the port's parity tests hold
  against the JAX package's ``run_filter`` and ``run_smc_sampler``
  (``WHOLE_RUN_ATOL`` and ``RUN_ATOL``, 0.05).
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro import ais as ja
from repro.core.spec import spec_for_backend as jax_spec_for_backend
from repro.pf import filter as jf
from repro.pf import models as jm
from repro_torch import ais as ta
from repro_torch import random as trandom
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.convert import key_from_jax
from repro_torch.core.spec import MegopolisSpec, spec_for_backend
from repro_torch.kernels.megopolis import ops as mops
from repro_torch.pf import filter as tf
from repro_torch.pf import models as tm
from repro_torch.resilience import record_resilience_events
from repro_torch.resilience.checkpointing import CheckpointPolicy, checkpointed_scan, scan
from repro_torch.resilience.errors import (
    BackendUnavailable,
    CorruptAncestorsError,
    InjectedCrash,
    KernelLaunchError,
    ResilienceError,
)
from repro_torch.resilience.fallback import (
    DEFAULT_LADDER,
    PROBE_N,
    _ladder_for,
    build_with_fallback,
    classify_backend_error,
)

CPU = "cpu"
#: The whole-run tolerances of ``test_torch_pf.py`` and ``test_torch_ais_parity.py``.
WHOLE_RUN_ATOL = 0.05
RUN_ATOL = 0.05


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _tkey(key):
    return key_from_jax(jax.random.key_data(key))


# ------------------------------------------------------------- taxonomy
def test_error_taxonomy():
    assert issubclass(KernelLaunchError, (ResilienceError, RuntimeError))
    assert issubclass(BackendUnavailable, (ResilienceError, RuntimeError))
    assert issubclass(CorruptAncestorsError, (ResilienceError, ValueError))
    assert issubclass(InjectedCrash, (ResilienceError, RuntimeError))
    assert BackendUnavailable("x", failures=[("cuda", KernelLaunchError("y"))]).failures[0][0] \
        == "cuda"


def test_classify_backend_error():
    wrapped = classify_backend_error(TypeError("something else entirely"))
    assert isinstance(wrapped, KernelLaunchError)
    assert isinstance(wrapped.__cause__, TypeError)
    already = KernelLaunchError("x")
    assert classify_backend_error(already) is already


def test_ladder_for_starts_at_spec_backend():
    assert DEFAULT_LADDER == ("cuda", "reference")
    assert _ladder_for("cuda", None) == DEFAULT_LADDER
    assert _ladder_for("reference", None) == ("reference",)
    assert _ladder_for("cuda", ("reference",)) == ("reference",)
    with pytest.raises(ValueError):
        _ladder_for("cuda", ())


# ------------------------------------------------------------- fallback
@pytest.fixture
def refused(monkeypatch):
    """The Megopolis kernel's launch refused, as ``check_launch`` reports a
    CUDA error (209, no kernel image for the device)."""
    def refuse(*args, **kwargs):
        raise KernelLaunchError("megopolis: CUDA error 209 at launch")

    monkeypatch.setattr(mops, "megopolis", refuse)


def test_fallback_first_rung_healthy_is_silent():
    events = []
    r = build_with_fallback(MegopolisSpec(num_iters=8), recorder=events, device=CPU)
    assert r.backend == "cuda" and events == []


def test_fallback_demotes_a_refused_rung(refused):
    events, active = [], []
    spec = MegopolisSpec(num_iters=8)
    with record_resilience_events(active):
        r = spec.build_resilient(recorder=events, device=CPU)
    assert r.backend == "reference"
    assert [e["kind"] for e in events] == ["backend_demotion"] and active == events
    assert events[0]["backend"] == "cuda" and events[0]["to_backend"] == "reference"
    assert events[0]["error_type"] == "KernelLaunchError"
    key = trandom.PRNGKey(3)
    w = torch.rand(PROBE_N, generator=torch.Generator().manual_seed(0))
    want = spec.replace(backend="reference").build()(key, w)
    assert torch.equal(r(key, w), want)


def test_build_never_demotes(refused):
    events = []
    with record_resilience_events(events):
        r = MegopolisSpec(num_iters=8).build()
        assert r.backend == "cuda"
        with pytest.raises(KernelLaunchError):
            r(trandom.PRNGKey(0), torch.full((PROBE_N,), 1.0 / PROBE_N))
    assert events == []


def test_fallback_exhaustion_raises_typed_error(refused):
    with pytest.raises(BackendUnavailable) as ei:
        build_with_fallback(MegopolisSpec(num_iters=8), ladder=("cuda",), device=CPU)
    assert len(ei.value.failures) == 1
    backend, cause = ei.value.failures[0]
    assert backend == "cuda" and isinstance(cause, ResilienceError)


def test_fallback_without_a_card_names_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(BackendUnavailable, match="device='cpu'") as ei:
        MegopolisSpec(num_iters=8).build_resilient()
    assert [b for b, _ in ei.value.failures] == ["cuda", "reference"]


# ------------------------------------------------------------ checkpoint
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.tensor([1, 2], dtype=torch.int64), torch.tensor(True)),
            "c": torch.tensor([0.5, -2.0], dtype=torch.bfloat16)}


def _same_tree(x, y):
    for k in ("a", "c"):
        assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k])
    for u, v in zip(x["b"], y["b"]):
        assert u.dtype == v.dtype and torch.equal(u, v)


def test_checkpoint_save_restore_round_trips(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    save_checkpoint(d, 7, tree, extra={"t_done": 7})
    assert latest_step(d) == 7
    got, manifest = restore_checkpoint(d, template=tree)
    _same_tree(got, tree)
    assert manifest["extra"] == {"t_done": 7} and manifest["dtypes"]["c"] == "bfloat16"
    flat, _ = restore_checkpoint(d, 7)
    assert sorted(flat) == ["a", "b/0", "b/1", "c"]
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, template={**tree, "a": torch.zeros(3)})


def test_checkpoint_manager_retention_and_async(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _tree())
    mgr.save_async(4, _tree())
    mgr.wait()
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003", "step_00000004"]
    assert latest_step(d) == 4
    _same_tree(restore_checkpoint(d, template=_tree())[0], _tree())


def test_no_partial_snapshot_is_visible(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, _tree())
    os.makedirs(os.path.join(d, "step_00000010.tmp"))  # a save cut short
    assert latest_step(d) == 5
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def _toy_scan_parts():
    def body(carry, x):
        carry = carry * 1.000001 + torch.sin(x)
        return carry, (carry, carry * 2.0)

    return body, torch.tensor(0.25), torch.linspace(0.0, 3.0, 11)


def test_checkpointed_scan_matches_monolith(tmp_path):
    body, init, xs = _toy_scan_parts()
    c0, ys0 = scan(body, init, xs)
    c1, ys1 = checkpointed_scan(body, init, xs, CheckpointPolicy(str(tmp_path / "ck"), every=4))
    assert torch.equal(c0, c1) and all(torch.equal(a, b) for a, b in zip(ys0, ys1))
    assert checkpointed_scan(body, init, xs, None)[1][0].shape == (11,)


def test_checkpointed_scan_kill_and_resume(tmp_path):
    body, init, xs = _toy_scan_parts()
    c0, ys0 = scan(body, init, xs)
    d = str(tmp_path / "ck")
    with pytest.raises(InjectedCrash):
        checkpointed_scan(body, init, xs, CheckpointPolicy(d, every=3, fail_after=6))
    assert latest_step(d) == 6
    c1, ys1 = checkpointed_scan(body, init, xs, CheckpointPolicy(d, every=3))
    assert torch.equal(c0, c1) and all(torch.equal(a, b) for a, b in zip(ys0, ys1))


def test_checkpoint_policy_validation(tmp_path):
    with pytest.raises(ValueError):
        CheckpointPolicy(directory="")
    with pytest.raises(ValueError):
        CheckpointPolicy(directory=str(tmp_path), every=0)
    with pytest.raises(TypeError, match="CheckpointPolicy"):
        checkpointed_scan(lambda c, x: (c, (x,)), 0, torch.zeros(2), object())


# ------------------------------------------------------- checkpointed runs
def _leaves(out):
    if isinstance(out, tuple):  # (estimates, Telemetry)
        return [out[0], *out[1].steps]
    return [out[k] for k in sorted(out)] if isinstance(out, dict) else [out]


def _same_leaves(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("family", ("systematic", "megopolis"))
def test_run_filter_kill_and_resume_bit_identical(tmp_path, family):
    """Killed at a snapshot mid-run and resumed: estimates and telemetry
    bit for bit with the uninterrupted run (``systematic`` on the reference
    backend as in the JAX test, Megopolis on the kernels' plain versions);
    the run's RMSE against the simulated truth (paper eq. 24) within
    ``WHOLE_RUN_ATOL`` of the JAX package's run, as ``test_torch_pf.py``
    and ``test_torch_prefix_sum.py`` hold whole runs."""
    n = 256 if family == "systematic" else 1024
    backend = "reference" if family == "systematic" else "cuda"
    tpf = tf.ParticleFilter(tm.ungm(), n, resampler=spec_for_backend(family, backend, num_iters=8),
                            ess_threshold=0.5)
    key = jax.random.PRNGKey(0)
    xs, zs = (np.array(a) for a in jf.simulate(jax.random.PRNGKey(1), jm.ungm(), 12))
    tobs = torch.from_numpy(zs)
    full = tf.run_filter(_tkey(key), tpf, tobs, telemetry=True, device=CPU)
    d = str(tmp_path / "pfck")
    with pytest.raises(InjectedCrash):
        tf.run_filter(_tkey(key), tpf, tobs, telemetry=True, device=CPU,
                      checkpoint=CheckpointPolicy(d, every=4, fail_after=8))
    assert latest_step(d) == 8
    resumed = tf.run_filter(_tkey(key), tpf, tobs, telemetry=True, device=CPU,
                            checkpoint=CheckpointPolicy(d, every=4))
    _same_leaves(resumed, full)
    jspec = jax_spec_for_backend(family, "reference" if backend == "reference"
                                 else "pallas_interpret", num_iters=8)
    jest, _ = jf.run_filter(key, jf.ParticleFilter(jm.ungm(), n, resampler=jspec,
                                                   ess_threshold=0.5), zs, telemetry=True)

    def rmse(est):
        return float(np.sqrt(np.mean((np.asarray(est) - xs) ** 2)))

    assert abs(rmse(resumed[0].numpy()) - rmse(jest)) <= WHOLE_RUN_ATOL


@pytest.mark.parametrize("bank", (False, True), ids=("single", "bank"))
def test_run_smc_sampler_checkpoint_resume(tmp_path, bank):
    """AIS killed after its first snapshot and resumed, geometric and
    adaptive: every leaf bit for bit; logZ within ``RUN_ATOL`` of the JAX
    package's run on the reference backends."""
    key = jax.random.PRNGKey(0)
    for schedule in ("geometric", "adaptive"):
        jcfg = ja.SMCSamplerConfig(num_particles=256, num_temps=8, schedule=schedule,
                                   resampler=jax_spec_for_backend("systematic", "xla"))
        tcfg = ta.SMCSamplerConfig(num_particles=256, num_temps=8, schedule=schedule,
                                   resampler=spec_for_backend("systematic", "reference"))
        target = ta.isotropic_gaussian(device=CPU)

        def run(checkpoint=None):
            if bank:
                return ta.run_smc_sampler_bank(_tkey(key), target, tcfg, num_scenarios=2,
                                               checkpoint=checkpoint, device=CPU)
            return ta.run_smc_sampler(_tkey(key), target, tcfg, checkpoint=checkpoint,
                                      device=CPU)

        full = run()
        d = str(tmp_path / f"ais-{schedule}")
        with pytest.raises(InjectedCrash):
            run(CheckpointPolicy(d, every=3, fail_after=3))
        resumed = run(CheckpointPolicy(d, every=3))
        _same_leaves(resumed, full)
        if bank:
            jo = ja.run_smc_sampler_bank(key, ja.isotropic_gaussian(), jcfg, num_scenarios=2)
        else:
            jo = ja.run_smc_sampler(key, ja.isotropic_gaussian(), jcfg)
        np.testing.assert_allclose(resumed["log_z"].numpy(), np.asarray(jo["log_z"]),
                                   atol=RUN_ATOL, rtol=0)
