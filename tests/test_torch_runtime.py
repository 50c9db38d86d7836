"""The port's training runtime (`repro_torch.runtime`) against the JAX
package's `repro.runtime`, on the CPU: the int8 gradient codec and its
error feedback bit for bit against eager JAX (under `jax.jit` the
reference divides by 127 as a product by 1/127, ROADMAP C.R5), and the
fault-tolerance pieces (AnomalyDetector, StepWatchdog, skip_or_apply,
PreemptionHandler) case by case, mirroring tests/test_ft.py."""

import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as JC
from repro.runtime import ft as JF
from repro_torch import tree as tree_lib
from repro_torch.runtime import compression as TC
from repro_torch.runtime import ft as TF

torch.set_num_threads(1)


def _grads(seed: int) -> dict:
    """A gradient-like tree: float32 and bfloat16 leaves, an all-zero
    leaf, ties at the absmax, and values on a rounding boundary."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(512).astype(np.float32)
    b = (rng.standard_normal((32, 16)) * 10).astype(np.float32)
    edge = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, 63.5, 64.5],
                    np.float32)
    return {"a": a, "b": b, "edge": edge,
            "zero": np.zeros(7, np.float32),
            "bf": jnp.asarray(rng.standard_normal(64), jnp.bfloat16)}


def _t(tree):
    return tree_lib.tree_map(lambda x: tree_lib.tensor_of(np.asarray(x),
                                                          "cpu"), tree)


def _bits_equal(got, want) -> None:
    gn, gl = tree_lib.flatten_with_names(got)
    wn, wl = tree_lib.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, want))
    assert gn == wn
    for n, g, w in zip(gn, gl, wl):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, n
        gb = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 \
            else g.numpy()
        wb = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(gb, wb, err_msg=n)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_and_decompress_equal_eager_jax(seed):
    g = _grads(seed)
    with jax.disable_jit():
        jq, js = JC.compress(g)
        jd = JC.decompress(jq, js)
    tq, ts = TC.compress(_t(g))
    _bits_equal(tq, jq)
    _bits_equal(ts, js)
    _bits_equal(TC.decompress(tq, ts), jd)


def test_error_feedback_equals_eager_jax_over_steps():
    jres = tres = None
    for step in range(4):
        g = _grads(10 + step)
        with jax.disable_jit():
            jd, jres = JC.with_error_feedback(g, jres)
        td, tres = TC.with_error_feedback(_t(g), tres)
        _bits_equal(td, jd)
        _bits_equal(tres, jres)


def test_compression_roundtrip_error():
    g = _t(_grads(3))
    back = TC.decompress(*TC.compress(g))
    for k in g:
        err = float((back[k] - g[k].float()).abs().max())
        assert err <= float(g[k].float().abs().max()) / 127 + 1e-7


def test_error_feedback_reduces_bias():
    """As tests/test_ft.py: the applied sum tracks the true sum within a
    few steps' quantisation error."""
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(256)
    applied = torch.zeros(256)
    residual = None
    for _ in range(50):
        g = {"g": torch.from_numpy(
            (rng.standard_normal(256) * 0.001 + 0.01).astype(np.float32))}
        true_sum += g["g"]
        deq, residual = TC.with_error_feedback(g, residual)
        applied += deq["g"]
    assert float((applied - true_sum).abs().max()) < 5 * 0.02 / 127


@pytest.mark.parametrize("case", ["nan_and_spike", "restart"])
def test_anomaly_detector_matches_the_reference(case):
    """The same sequence of checks gives the same decisions, stored norms
    and restart signal in both packages."""
    if case == "nan_and_spike":
        kw = dict(spike_factor=5.0, warmup_steps=5)
        seq = ([(1.0, 1.0 + 0.01 * i) for i in range(10)]
               + [(float("nan"), 1.0), (1.0, 100.0), (1.0, 1.1),
                  (1.0, float("inf")), (float("inf"), 1.0)])
    else:
        kw = dict(max_skips_in_row=3, warmup_steps=0, spike_factor=2.0)
        seq = [(1.0, 1.0)] + [(1.0, 1e9)] * 3 + [(1.0, 1.5)]
    j = JF.AnomalyDetector(JF.AnomalyConfig(**kw))
    t = TF.AnomalyDetector(TF.AnomalyConfig(**kw))
    for loss, gn in seq:
        assert t.check(loss, gn) == j.check(loss, gn)
        assert t.norms == j.norms
        assert t.should_restart == j.should_restart
        assert t.skips_in_row == j.skips_in_row


def test_skip_or_apply_matches_the_reference():
    old = {"w": np.zeros(3, np.float32),
           "b": {"c": np.arange(4, dtype=np.float32)}}
    new = {"w": np.ones(3, np.float32),
           "b": {"c": np.arange(4, dtype=np.float32) + 5}}
    for ok in (True, False):
        want = JF.skip_or_apply(jnp.bool_(ok), new, old)
        got = TF.skip_or_apply(torch.tensor(ok), _t(new), _t(old))
        _bits_equal(got, want)


def test_watchdog_matches_the_reference():
    """Both watchdogs fed the same step times (their clocks replaced)."""
    times = [0.002] * 3 + [0.03] * 2 + [0.002, 0.05, 0.05, 0.05]
    dogs = [JF.StepWatchdog(slow_factor=3.0, patience=2),
            TF.StepWatchdog(slow_factor=3.0, patience=2)]
    clock = {"now": 0.0}
    mods = (JF.time, TF.time)
    saved = [m.monotonic for m in mods]
    for m in mods:
        m.monotonic = lambda: clock["now"]
    try:
        for dt in times:
            out = []
            for dog in dogs:
                clock["now"] = 0.0
                dog.start()
                clock["now"] += dt
                out.append(dog.stop())
            assert out[0] == out[1]
            assert dogs[0].ewma == dogs[1].ewma
            assert dogs[0].straggling == dogs[1].straggling
    finally:
        for m, f in zip(mods, saved):
            m.monotonic = f


def test_watchdog_flags_sustained_slowdown():
    dog = TF.StepWatchdog(slow_factor=3.0, patience=2)
    for _ in range(3):
        dog.start()
        time.sleep(0.002)
        dog.stop()
    assert not dog.straggling
    for _ in range(2):
        dog.start()
        time.sleep(0.03)
        dog.stop()
    assert dog.straggling


def test_preemption_handler_catches_sigterm():
    """Installed in the main thread, a SIGTERM sets `preempted` (the
    process's handlers are restored after)."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        h = TF.PreemptionHandler()
        assert not h.preempted
        signal.raise_signal(signal.SIGTERM)
        assert h.preempted
    finally:
        for s, f in saved.items():
            signal.signal(s, f)
