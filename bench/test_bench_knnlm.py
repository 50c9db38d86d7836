"""The kNN-LM family on the CPU at its dry size (bench/run.py --dry): the
published DeepSeek-V3 router and YaRN at the port's smoke widths, served
through make_serve_step_with_mcam in place. The sound program reads
correct, with the head's search bit for bit against bench/reference/
mcam.py; the float8 control and two planted faults (a router without its
group limit, an attention scale without YaRN's mscale**2) read not
correct."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CELL = "dsv3-knnlm-decode-8k"
SEARCH = ("query_words_wrong", "rows_wrong", "dist_wrong", "votes_wrong",
          "labels_wrong")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(seed: int, program=None) -> dict:
    c = harness.dry(harness.load_cell(CELL))
    c = dataclasses.replace(c, traffic=dict(c.traffic, warmup_batches=1))
    return harness.run(c, seed, 0.3, False, "cpu", program=program)


def test_run_dry_reads_correct_with_the_search_bit_for_bit():
    """bench/run.py --dry --trace 1 in a process of its own (no JAX
    loaded): correct, every search number 0, the step's mfu read (0
    where no step of the short window finished on a busy CPU)."""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELL, "--seed",
         "4100000003", "--seconds", "0.5", "--dry", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert all(line["compared"][k]["value"] == 0 for k in SEARCH)
    assert line["metrics"]["decode_mfu"]["value"] >= 0


def test_float8_control_is_not_correct(capsys):
    from bench import control
    assert control.main(["--workload", CELL, "--seeds", "4100000005",
                         "--seconds", "0.3", "--dry"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and not line["correct"]
    assert line["attn_err"] > 0.02 and line["ffn_err"] > 0.02
    assert all(line[k] == 0 for k in SEARCH)


def test_router_without_its_group_limit_is_caught(monkeypatch):
    from repro_torch.models import moe
    real = moe.route_groups

    def ungrouped(logits, bias, m):
        return real(logits, bias, dataclasses.replace(m,
                                                      topk_group=m.n_group))
    monkeypatch.setattr(moe, "route_groups", ungrouped)
    out = _run(4100000007)
    assert not out["correct"]
    assert out["compared"]["router_wrong"]["value"] > 0


def test_attention_scale_without_mscale_squared_is_caught(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "yarn_mscale", lambda factor, m: 1.0)
    out = _run(4100000009)
    assert not out["correct"]
    assert out["compared"]["attn_err"]["value"] > \
        out["compared"]["attn_err"]["limit"]


def _stream_through_float8(monkeypatch):
    from repro_torch.models import transformer
    real = transformer._decode_stream

    def stream8(x, decode):
        x = real(x, decode)
        return x.to(torch.float8_e4m3fn).to(x.dtype) if decode else x
    monkeypatch.setattr(transformer, "_decode_stream", stream8)


def _ffn_norm_without_its_scale(monkeypatch):
    from repro_torch.models import layers, transformer
    real_layer, real_norm = transformer._layer_apply, layers.apply_norm
    calls = [0]

    def layer_apply(*a, **k):
        calls[0] = 0
        return real_layer(*a, **k)

    def apply_norm(p, x, cfg, *a, **k):
        calls[0] += 1
        if calls[0] == 2:      # a layer's second norm: the FFN's
            p = dict(p, scale=torch.ones_like(p["scale"]))
        return real_norm(p, x, cfg, *a, **k)
    monkeypatch.setattr(transformer, "_layer_apply", layer_apply)
    monkeypatch.setattr(layers, "apply_norm", apply_norm)


@pytest.mark.parametrize("plant", [_stream_through_float8,
                                   _ffn_norm_without_its_scale],
                         ids=["stream_float8", "norm2_unscaled"])
def test_stream_faults_are_caught(monkeypatch, plant):
    """The faults `stream_err` is held to (the cell's file): the residual
    stream rounded through float8 each layer, and the FFN's norm without
    its drawn scale, read over the limit while attention and FFN pass."""
    plant(monkeypatch)
    out = _run(4100000013)
    c = out["compared"]
    assert not out["correct"]
    assert c["stream_err"]["value"] > c["stream_err"]["limit"]
    assert c["attn_err"]["value"] <= c["attn_err"]["limit"]
