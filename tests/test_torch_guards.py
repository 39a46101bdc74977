"""The degeneracy guard (DESIGN.md §16) of the port against the JAX package's,
on the CPU, and its events.

* ``guard="recover"`` on a bank with a collapsed row: the port's ``cuda``
  backend (the kernels' plain versions here) gives the ancestors and
  particles of JAX's ``pallas_interpret`` recovery bit for bit, at every
  plane dtype, for every family; the reference backend JAX's reference.
* A collapsed linear-weight row resamples exactly like the uniform bank;
  clean rows are untouched; the collapsed log-weight step resamples the
  uniform bank with ``degenerate``, ``ess_norm = 1`` and ``incr = 0``.
* ``guard="flag"`` calls the torch functions of ``'off'`` when no recorder
  is active, and emits one ``guard_degenerate`` event per call that saw a
  collapsed row while one is; the events reach a ``JsonlSink``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import spec_for_backend as jax_spec_for_backend
from repro_torch import random as trandom
from repro_torch.analysis.guards import CallLog
from repro_torch.convert import key_from_jax
from repro_torch.core.metrics import degenerate_log_weights, degenerate_weights
from repro_torch.core.spec import MegopolisSpec, PrefixSumSpec, list_resamplers, spec_for_backend
from repro_torch.obs.sink import JsonlSink
from repro_torch.resilience import (
    GUARD_POLICIES,
    ResilienceEvent,
    classify_step_stats,
    demotion_event,
    emit_event,
    guard_events_enabled,
    record_resilience_events,
)

N, D, B, MAX_ITERS = 2048, 2, 8, 24
DTYPES = ("float32", "bfloat16", "float16")
JAX_BACKEND = {"cuda": "pallas_interpret", "reference": "reference"}


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _build(name, backend, guard, plane_dtype="float32"):
    kw = dict(num_iters=B, max_iters=MAX_ITERS, plane_dtype=plane_dtype, guard=guard)
    return (jax_spec_for_backend(name, JAX_BACKEND[backend], **kw).build(),
            spec_for_backend(name, backend, **kw).build())


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.itemsize]) if x.dtype.kind == "f" else x


def _collapsed_bank(seed: int):
    """Log-weights [3, N]: row 0 all -inf, row 1 one NaN, row 2 clean."""
    rng = np.random.default_rng(seed)
    lw = (rng.standard_normal((3, N)) * 2.0).astype(np.float32)
    lw[0] = -np.inf
    lw[1, 5] = np.nan
    p = rng.standard_normal((3, N, D)).astype(np.float32)
    return lw, p


def _keys(seed, rows):
    jk = jax.random.split(jax.random.PRNGKey(seed), rows)
    return jk, key_from_jax(jax.random.key_data(jk))


@pytest.mark.parametrize("plane_dtype", DTYPES)
@pytest.mark.parametrize("name", list_resamplers())
def test_recover_step_rows_matches_jax_pallas_interpret(name, plane_dtype):
    jr, tr = _build(name, "cuda", "recover", plane_dtype)
    lw, p = _collapsed_bank(1)
    jk, tk = _keys(2, 3)
    # threshold 2: every row resamples, the recovered ones from the uniform bank
    jp, ja, js = jr.step_rows(jk, jnp.asarray(lw), jnp.asarray(p), 2.0)
    tp, ta, ts = tr.step_rows(tk, torch.from_numpy(lw), torch.from_numpy(p), 2.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))
    np.testing.assert_array_equal(ts.degenerate.numpy(), [True, True, False])
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))
    assert ts.ess_norm[:2].tolist() == [1.0, 1.0]
    assert ts.log_evidence_incr[:2].tolist() == [0.0, 0.0]
    assert bool(torch.isfinite(tp).all())


@pytest.mark.parametrize("plane_dtype", DTYPES)
@pytest.mark.parametrize("name", ("megopolis", "metropolis_c2", "rejection", "residual"))
def test_recover_apply_rows_matches_jax_pallas_interpret(name, plane_dtype):
    """A degenerate linear-weight row (zero mass, a NaN, an inf) becomes
    ``1/N``, rounded to the plane word the kernels move: JAX's recovery
    writes ``1/N`` in float32 and its kernel narrows it, the port narrows
    first, and both give the same word."""
    jr, tr = _build(name, "cuda", "recover", plane_dtype)
    rng = np.random.default_rng(3)
    w = rng.gamma(0.5, size=(3, N)).astype(np.float32)
    w[0] = 0.0
    w[1, 7] = np.nan
    w[2, 9] = np.inf
    p = rng.standard_normal((3, N, D)).astype(np.float32)
    jk, tk = _keys(4, 3)
    jp, ja = jr.apply_rows(jk, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply_rows(tk, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))


@pytest.mark.parametrize("plane_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", ("megopolis", "metropolis_c1", "rejection", "stratified"))
def test_recover_reference_matches_jax_reference(name, plane_dtype):
    jr, tr = _build(name, "reference", "recover", plane_dtype)
    lw, p = _collapsed_bank(5)
    jk, tk = _keys(6, 3)
    jp, ja, _ = jr.step_rows(jk, jnp.asarray(lw), jnp.asarray(p), 2.0)
    tp, ta, _ = tr.step_rows(tk, torch.from_numpy(lw), torch.from_numpy(p), 2.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))


def test_recovered_plane_word_of_one_over_n():
    """The uniform bank's 1/N lands on the same 2-byte word whichever side
    narrows: JAX recovers in float32 then narrows, the port narrows first."""
    from repro_torch.kernels.common import compress_plane

    for n in (1000, 2048, 1 << 20):
        for name, jdt in (("bfloat16", jnp.bfloat16), ("float16", jnp.float16)):
            want = np.asarray(jnp.asarray(np.float32(1.0 / n)).astype(jdt)).view(np.int16)
            got = torch.full((n,), 1.0 / n).to(getattr(torch, name))
            assert got[0].view(torch.int16).item() == int(want)
            assert torch.equal(compress_plane(torch.full((n,), 1.0 / n), name), got)


@pytest.mark.parametrize("backend", ("cuda", "reference"))
@pytest.mark.parametrize("name", ("megopolis", "rejection", "systematic"))
def test_recover_weights_entries_equal_uniform(name, backend):
    _, r = _build(name, backend, "recover")
    key = trandom.PRNGKey(0)
    w_uni = torch.full((N,), 1.0 / N)
    p = torch.randn(N, 2, generator=torch.Generator().manual_seed(3))
    bads = (torch.zeros(N), torch.full((N,), float("nan")), w_uni.clone().index_fill_(
        0, torch.tensor([5]), float("inf")))
    for w_bad in bads:
        assert torch.equal(r(key, w_bad), r(key, w_uni))
        got, want = r.apply(key, w_bad, p), r.apply(key, w_uni, p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    keys = trandom.split(key, 2)
    p_bank = torch.randn(2, N, 2, generator=torch.Generator().manual_seed(4))
    got = r.apply_rows(keys, torch.stack([bads[1], w_uni]), p_bank)
    want = r.apply_rows(keys, torch.stack([w_uni, w_uni]), p_bank)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("backend", ("cuda", "reference"))
def test_recover_step_resamples_collapsed_bank(backend):
    _, r = _build("megopolis", backend, "recover")
    key = trandom.PRNGKey(0)
    p = torch.randn(N, 2, generator=torch.Generator().manual_seed(5))
    for bad in (torch.full((N,), float("nan")), torch.full((N,), float("-inf"))):
        p_out, anc, stats = r.step(key, bad, p, 2.0)
        assert bool(stats.degenerate) and float(stats.resampled) == 1.0
        assert float(stats.ess_norm) == 1.0 and float(stats.log_evidence_incr) == 0.0
        assert bool(((anc >= 0) & (anc < N)).all()) and bool(torch.isfinite(p_out).all())
        want = r.step(key, torch.zeros(N), p, 2.0)
        for g, e in zip((p_out, anc, *stats[:-1]), (want[0], want[1], *want[2][:-1])):
            assert torch.equal(g, e)


@pytest.mark.parametrize("backend", ("cuda", "reference"))
@pytest.mark.parametrize("name", ("megopolis", "metropolis", "multinomial"))
def test_flag_calls_the_torch_functions_of_off(name, backend):
    """Without a recorder, 'flag' is 'off': the same torch calls outside the
    kernel wrappers, on every entry, the same outputs."""
    _, off = _build(name, backend, "off")
    _, flag = _build(name, backend, "flag")
    key, keys = trandom.PRNGKey(1), trandom.split(trandom.PRNGKey(1), 2)
    w, lw = torch.rand(2, N), torch.randn(2, N)
    p = torch.randn(2, N, 2)
    for call in (lambda r: r(key, w[0]), lambda r: r.batch(key, w),
                 lambda r: r.apply_rows(keys, w, p), lambda r: r.step(key, lw[0], p[0], 0.5),
                 lambda r: r.step_rows(keys, lw, p, 0.5)):
        with CallLog() as a:
            out_off = call(off)
        with CallLog() as b:
            out_flag = call(flag)
        assert a.calls == b.calls
        flat = lambda o: [t for x in (o if isinstance(o, tuple) else (o,))  # noqa: E731
                          for t in (x if isinstance(x, tuple) else (x,))]
        assert all(torch.equal(x, y) for x, y in zip(flat(out_off), flat(out_flag)))


def test_flag_events_only_inside_the_recorder():
    _, r = _build("megopolis", "reference", "flag")
    key = trandom.PRNGKey(2)
    p = torch.randn(N)
    bad = torch.full((N,), float("nan"))
    events = []
    with record_resilience_events(events):
        assert guard_events_enabled()
        _, _, stats = r.step(key, bad, p, 2.0)
        r.step(key, torch.zeros(N), p, 2.0)  # clean: silent
        keys = trandom.split(key, 4)
        bank = torch.zeros(4, N)
        bank[1] = float("-inf")
        bank[3, 0] = float("nan")
        r.step_rows(keys, bank, torch.zeros(4, N), 2.0)
        r.apply(key, torch.zeros(N), p)  # zero mass: degenerate linear weights
    assert not guard_events_enabled()
    assert bool(stats.degenerate)
    assert [(e["kind"], e["entry"], e["policy"], e["degenerate_rows"], e["bank_rows"])
            for e in events] == [("guard_degenerate", "step", "flag", 1, 1),
                                 ("guard_degenerate", "step_rows", "flag", 2, 4),
                                 ("guard_degenerate", "apply", "flag", 1, 1)]
    assert events[0]["family"] == "megopolis" and events[0]["backend"] == "reference"
    r.step(key, bad, p, 2.0)  # outside the recorder: nothing to deliver to
    assert len(events) == 3


def test_guard_events_reach_jsonl_sink(tmp_path):
    path = tmp_path / "resilience.jsonl"
    _, r = _build("megopolis", "cuda", "recover")
    with JsonlSink(str(path)) as sink:
        with record_resilience_events(sink):
            r.step(trandom.PRNGKey(3), torch.full((N,), float("-inf")), torch.randn(N), 2.0)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["guard_degenerate"]
    assert (lines[0]["policy"], lines[0]["backend"], lines[0]["degenerate_rows"]) == \
        ("recover", "cuda", 1)


def test_jsonl_sink_buffers_and_seals(tmp_path):
    path = tmp_path / "sink" / "events.jsonl"
    sink = JsonlSink(str(path), buffer_size=3)
    sink.emit("a", x=1)
    sink.emit("b", t=torch.tensor(1.5))  # not JSON: stringified, not dropped
    assert not path.exists()
    sink.emit("c")
    assert len(path.read_text().splitlines()) == 3
    sink.emit("d")
    sink.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["event"] for r in rows] == ["a", "b", "c", "d"] and isinstance(rows[1]["t"], str)
    with pytest.raises(ValueError):
        sink.emit("e")
    with pytest.raises(ValueError):
        JsonlSink(str(path), buffer_size=0)


def test_guard_vocabulary_and_validation():
    assert GUARD_POLICIES == ("off", "flag", "recover")
    for g in GUARD_POLICIES:
        assert MegopolisSpec(guard=g).guard == g
    with pytest.raises(ValueError, match="recover"):
        MegopolisSpec(guard="recovr")
    with pytest.raises(ValueError, match="guard"):
        PrefixSumSpec(kind="systematic", guard="on")


def test_degenerate_predicates():
    n = 8
    assert bool(degenerate_log_weights(torch.full((n,), float("-inf"))))
    assert bool(degenerate_log_weights(torch.full((n,), float("nan"))))
    assert bool(degenerate_log_weights(torch.zeros(n).index_fill(0, torch.tensor([3]),
                                                                 float("inf"))))
    one_hot = torch.full((n,), float("-inf"))
    one_hot[2] = 0.0
    assert not bool(degenerate_log_weights(one_hot))
    assert bool(degenerate_weights(torch.zeros(n)))
    assert not bool(degenerate_weights(torch.ones(n)))


def test_classify_and_demotion_events():
    _, r = _build("megopolis", "cuda", "recover")
    _, _, stats = r.step(trandom.PRNGKey(4), torch.full((N,), float("nan")), torch.randn(N),
                         2.0)
    c = classify_step_stats(stats, N)
    assert c["degenerate"] and c["any"] and not c["ess_floor"]
    ev = demotion_event("megopolis", "cuda", "reference", RuntimeError("no card"))
    assert ev.as_dict() == {"kind": "backend_demotion", "family": "megopolis",
                            "backend": "cuda", "entry": "build", "policy": "",
                            "to_backend": "reference", "error_type": "RuntimeError",
                            "error": "no card"}
    got = []
    with record_resilience_events(got):
        emit_event(ResilienceEvent(kind="fault_injected", family="x"))
    assert got == [{"kind": "fault_injected", "family": "x", "backend": "", "entry": "",
                    "policy": ""}]
