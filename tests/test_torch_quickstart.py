"""The port's quickstart twin (`repro_torch.examples.quickstart`) against
the JAX package's `examples/quickstart.py`, loaded by path, on the CPU.

The JAX side searches on `backend="ref"` under `jax.jit`: its `auto` full
search reaches the Pallas string-search kernel, which the installed JAX
cannot run (ROADMAP C.R2, R1). The twin draws its clustered data from
numpy, the reference from jax.random, so the accuracy lines are compared
in kind (100%), and the cost-model lines character for character.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import torch

from repro.engine import RetrievalEngine as JEngine
from repro_torch.examples import quickstart

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _JittedRefEngine:
    """The JAX engine on the ref backend, each search under jax.jit."""

    def __init__(self, cfg):
        self.eng = JEngine(cfg, backend="ref")

    def search(self, store, queries, request):
        return jax.jit(lambda s, q: self.eng.search(s, q, request))(
            store, jnp.asarray(queries))


def test_quickstart_twin_prints_the_reference_lines(capsys, monkeypatch):
    """The iteration, throughput and capacity lines are the JAX
    quickstart's, character for character, and both searches answer every
    query right (100%), as the reference's do on its own data."""
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    monkeypatch.setattr(jq, "RetrievalEngine", _JittedRefEngine)
    jq.main()
    want = capsys.readouterr().out.splitlines()
    got_acc = quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[2:] == want[2:]
    assert [line.split("accuracy")[0] for line in got[:2]] == \
        [line.split("accuracy")[0] for line in want[:2]]
    for line in got[:2] + want[:2]:
        assert "accuracy 100.00%" in line
    assert got_acc == {"full": 1.0, "two_phase": 1.0}
