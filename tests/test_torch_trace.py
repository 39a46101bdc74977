"""The port's dispatch spans (``repro_torch.obs.trace``, DESIGN.md §15) on
the CPU: identity while disabled, one span of the right name per
``Resampler`` entry while enabled, and the same launch census either way."""

import pytest
import torch

from repro_torch import random as trandom
from repro_torch.analysis.consumers import audit_consumers
from repro_torch.analysis.contracts import record
from repro_torch.core.spec import MegopolisSpec, PrefixSumSpec
from repro_torch.obs import trace

N, S, D = 1024, 2, 2
ENTRIES = ("single", "batch", "batch_rows", "apply", "apply_batch", "apply_rows", "step",
           "step_rows")


@pytest.fixture
def tracing():
    trace.enable_tracing(True)
    try:
        yield
    finally:
        trace.enable_tracing(False)


def _calls(r):
    """Every public entry of ``r`` once, by the name its span carries."""
    key, keys = trandom.PRNGKey(0), trandom.split(trandom.PRNGKey(1), S)
    w, bank = torch.full((N,), 1.0 / N), torch.full((S, N), 1.0 / N)
    p, pb = torch.zeros(N, D), torch.zeros(S, N, D)
    return {
        "single": lambda: r(key, w), "batch": lambda: r.batch(key, bank),
        "batch_rows": lambda: r.batch_rows(keys, bank),
        "apply": lambda: r.apply(key, w, p), "apply_batch": lambda: r.apply_batch(key, bank, pb),
        "apply_rows": lambda: r.apply_rows(keys, bank, pb),
        "step": lambda: r.step(key, torch.zeros(N), p, 0.5),
        "step_rows": lambda: r.step_rows(keys, torch.zeros(S, N), pb, 0.5),
    }


def _span_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.count("/") == 3]


def test_spans_are_identity_when_disabled():
    assert not trace.tracing_enabled()  # REPRO_TRACE unset
    r = MegopolisSpec(num_iters=4).build()
    for fn in _calls(r).values():
        assert _span_names(fn) == []
    with trace.span("anything"):
        pass


@pytest.mark.parametrize("spec", (MegopolisSpec(num_iters=4),
                                  MegopolisSpec(num_iters=4, plane_dtype="bfloat16"),
                                  PrefixSumSpec(kind="residual", backend="reference")),
                         ids=("megopolis", "megopolis-bf16", "residual-reference"))
def test_each_entry_opens_one_named_span(tracing, spec):
    r = spec.build()
    for entry, fn in _calls(r).items():
        assert _span_names(fn) == [f"{spec.name}/{spec.backend}/{entry}/{spec.plane_dtype}"]


def test_spans_nest_the_kernel_wrappers_work(tracing):
    r = MegopolisSpec(num_iters=4).build()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.step(trandom.PRNGKey(0), torch.zeros(N), torch.zeros(N), 0.5)
    span = next(e for e in prof.events() if e.name == "megopolis/cuda/step/float32")
    inside = [e for e in prof.events() if e.time_range.start >= span.time_range.start
              and e.time_range.end <= span.time_range.end and e is not span]
    assert inside  # the step's torch ops ran under the span


def test_census_is_the_same_with_spans_on_and_off():
    r = MegopolisSpec(num_iters=4).build()
    off = {entry: dict(record(fn, taint=False)[1].census) for entry, fn in _calls(r).items()}
    consumers = ("pf.run_filter_bank", "ais.adaptive_mala")
    reps_off = {rep.cell: rep.census for rep in audit_consumers(consumers, device="cpu")}
    trace.enable_tracing(True)
    try:
        on = {entry: dict(record(fn, taint=False)[1].census) for entry, fn in _calls(r).items()}
        reps_on = {rep.cell: rep.census for rep in audit_consumers(consumers, device="cpu")}
    finally:
        trace.enable_tracing(False)
    assert on == off and all(sum(c.values()) == 1 for c in on.values())
    assert reps_on == reps_off and len(reps_on) == 2
