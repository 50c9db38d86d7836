"""Parity of the port's dry run (`repro_torch.launch.dryrun`,
`configs.supports_shape`) with the JAX package's, on the CPU.

`supports_shape` and `model_flops` must equal the reference's for every
arch of `configs.ARCHS` at smoke and full width, on every shape (the
few-shot controllers' configs raise alike in both packages). The state a
mesh position holds (`_tree_bytes_per_device` of the parameters, the
optimizer state and the KV caches) must equal the reference's on the
(4, 2), (2, 2, 2), (16, 16) and (2, 16, 16) meshes at both widths; the
JAX side is shapes only (`NamedSharding.shard_shape` over a
`jax.sharding.Mesh` of the one CPU device repeated; nothing compiles).

The trace (analysis/cost.py) of a smoke train step gives the same FLOPs,
bytes and peak on the meta device as on the CPU, and its FLOPs are
linear in depth (an eager trace counts every layer: the port's
counterpart of the reference's trip-count correction). The reference
test's small-mesh cell (deepseek-moe-16b smoke, train_4k cut to 8 x 64
in microbatches of 4, on (2, 2, 2)) runs to `status == "ok"` with the
reference's record keys; its compile raises on this JAX (ROADMAP C.R9),
so the anchor is its state bytes, held to the JAX-side shapes.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.launch import dryrun as j_dryrun
from repro.launch import steps as j_steps
from repro.models import sharding as j_sharding
from repro.models import transformer as j_tfm
from repro_torch import configs as t_configs
from repro_torch import tree as tree_lib
from repro_torch.analysis import cost as cost_lib
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import rules_for_mesh

torch.set_num_threads(1)

LM_ARCHS = [a for a in t_configs.ARCHS
            if a not in ("omniglot-conv4", "cub-resnet12")]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the archs whose state bytes are held on every mesh and width: dense
# with bf16 moments, MLA + MoE with adafactor, mLSTM / sLSTM, hybrid
# (deepseek-moe-16b's on (2, 2, 2) in the small-mesh cell)
STATE_ARCHS = ("llama3-405b", "deepseek-v3-671b", "xlstm-350m",
               "hymba-1.5b")
# the reference record's keys (repro/launch/dryrun.run_cell)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "chips", "compile_s",
               "flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "collectives_corrected",
               "raw_uncorrected", "memory_analysis",
               "state_bytes_per_device", "model_flops_total",
               "useful_flops_ratio", "roofline"}


def _outcome(fn):
    """fn()'s value, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as e:          # both packages must fail alike
        return type(e).__name__


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_supports_shape_and_model_flops_equal_reference(arch, smoke,
                                                        monkeypatch):
    # each package's model_flops builds the abstract parameters once a
    # shape: build them once a config (the same trees, the same count)
    for mod in (j_dryrun, t_dryrun):
        monkeypatch.setattr(mod.tfm, "abstract_params", functools.lru_cache(
            maxsize=None)(mod.tfm.abstract_params))
    jcfg = j_configs.load_config(arch, smoke=smoke)
    tcfg = t_configs.load_config(arch, smoke=smoke)
    for name in j_base.SHAPES:
        js, ts = j_base.SHAPES[name], t_configs.SHAPES[name]
        assert _outcome(lambda: t_configs.supports_shape(tcfg, ts)) == \
            _outcome(lambda: j_configs.supports_shape(jcfg, js)), name
        assert _outcome(lambda: t_dryrun.model_flops(tcfg, ts)) == \
            _outcome(lambda: j_dryrun.model_flops(jcfg, js)), name


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, smoke: bool):
    jcfg = j_configs.load_config(arch, smoke=smoke)
    tcfg = t_configs.load_config(arch, smoke=smoke)
    return jcfg, tcfg, j_tfm.abstract_params(jcfg), tfm.abstract_params(tcfg)


def _jax_state_bytes(jcfg, params_abs, shape_dims, axes, decode) -> tuple:
    n = int(np.prod(shape_dims))
    mesh = jax.sharding.Mesh(
        np.array(jax.devices() * n)[:n].reshape(shape_dims), axes)
    rules = j_sharding.rules_for_mesh(mesh)
    p_shard = j_steps.param_shardings(jcfg, mesh, rules)
    params_in = j_dryrun._with_shardings(params_abs, p_shard)
    opt = j_steps.optimizer_for(jcfg, j_base.TrainConfig())
    opt_abs = jax.eval_shape(opt.init, params_abs)
    opt_in = j_dryrun._with_shardings(opt_abs, j_steps.opt_shardings(
        opt_abs, params_abs, p_shard, mesh, rules))
    c_shard, cache_abs = j_steps.cache_shardings(
        jcfg, decode.global_batch, decode.seq_len, mesh, rules)
    cache_in = j_dryrun._with_shardings(cache_abs, c_shard)
    return tuple(j_dryrun._tree_bytes_per_device(t)
                 for t in (params_in, opt_in, cache_in))


def _specs(abstract, shardings):
    return tree_lib.tree_map(
        lambda a, s: S.InputSpec(tuple(a.shape), a.dtype, s), abstract,
        shardings)


def _port_state_bytes(tcfg, params_abs, shape_dims, axes, decode) -> tuple:
    mesh = Mesh.repeat("meta", shape_dims, axes)
    rules = rules_for_mesh(mesh)
    p_shard = S.param_shardings(tcfg, mesh, rules)
    opt_abs = S.optimizer_for(tcfg, TrainConfig()).init(params_abs)
    o_shard = S.opt_shardings(opt_abs, params_abs, p_shard, mesh, rules)
    c_shard, cache_abs = S.cache_shardings(
        tcfg, decode.global_batch, decode.seq_len, mesh, rules)
    return tuple(t_dryrun._tree_bytes_per_device(_specs(a, s))
                 for a, s in ((params_abs, p_shard), (opt_abs, o_shard),
                              (cache_abs, c_shard)))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_bytes_per_position_equal_reference(mesh, smoke):
    """Parameters, optimizer state and decode_32k caches, per position."""
    dims, axes = MESHES[mesh]
    for arch in STATE_ARCHS:
        jcfg, tcfg, jabs, tabs = _abstract(arch, smoke)
        want = _jax_state_bytes(jcfg, jabs, dims, axes,
                                j_base.SHAPES["decode_32k"])
        got = _port_state_bytes(tcfg, tabs, dims, axes,
                                t_configs.SHAPES["decode_32k"])
        assert got == want, (arch, got, want)


def _smoke_train(arch: str, layers: int | None = None):
    cfg = t_configs.load_config(arch, smoke=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    step, optimizer = S.make_train_step(cfg, TrainConfig(learning_rate=1e-3))
    return cfg, step, optimizer


def _step_inputs(cfg, optimizer, device, accum=2, mb=2, seq=8):
    if device == "meta":
        params = tfm.abstract_params(cfg)
    else:
        params = tfm.init(torch.Generator().manual_seed(0), cfg)
    state = optimizer.init(params)
    batch = {k: torch.zeros((accum, mb, seq), dtype=torch.int32,
                            device=device) for k in ("tokens", "labels")}
    return params, state, batch


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-moe-16b"])
def test_trace_equal_on_meta_and_cpu(arch):
    """One smoke train step traced on meta tensors and on CPU tensors:
    the same FLOPs, bytes, temp and peak bytes, census and host syncs."""
    cfg, step, optimizer = _smoke_train(arch)
    recs = {}
    for dev in ("meta", "cpu"):
        recs[dev] = cost_lib.traced_cost(
            step, *_step_inputs(cfg, optimizer, dev))
    for key in ("flops", "hbm_bytes_read", "hbm_bytes_written",
                "temp_bytes", "peak_bytes", "op_census", "host_syncs"):
        assert recs["meta"][key] == recs["cpu"][key], key
    assert recs["cpu"]["flops"] > 0 and recs["cpu"]["host_syncs"] == 0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "llama3-405b"])
def test_flops_linear_in_depth(arch):
    """count(L) = count(1) + (L - 1) (count(2) - count(1)) over a stack
    of one layer type: every layer is counted, the trip-count
    correction's counterpart."""
    counts = {}
    for layers in (1, 2, 4):
        cfg, step, optimizer = _smoke_train(arch, layers)
        counts[layers] = cost_lib.traced_cost(
            step, *_step_inputs(cfg, optimizer, "meta"))["flops"]
    assert counts[2] > counts[1]
    assert counts[4] == counts[1] + 3 * (counts[2] - counts[1])


def _small_mesh_cell(monkeypatch):
    """The reference test's shrunk cell: (2, 2, 2) positions, train_4k cut
    to 8 x 64 in microbatches of 4, smoke configs."""
    monkeypatch.setattr(t_dryrun, "meta_mesh", lambda multi_pod: Mesh.repeat(
        "meta", (2, 2, 2) if multi_pod else (4, 2),
        ("pod", "data", "model") if multi_pod else ("data", "model")))
    shapes = dict(t_configs.SHAPES)
    shapes["train_4k"] = ShapeConfig("train_4k", 64, 8, "train", 4)
    monkeypatch.setattr(t_dryrun, "SHAPES", shapes)
    real = t_configs.load_config
    monkeypatch.setattr(t_dryrun, "load_config",
                        lambda arch, smoke=False: real(arch, smoke=True))


def test_small_mesh_cell_runs_with_reference_keys(monkeypatch):
    _small_mesh_cell(monkeypatch)
    rec = t_dryrun.run_cell("deepseek-moe-16b", "train_4k", multi_pod=True)
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec) and "flops_total" in rec
    assert rec["flops_per_device"] > 0 and rec["chips"] == 8
    assert rec["flops_total"] == rec["flops_per_device"] * 8
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["raw_uncorrected"]["flops"] == rec["flops_per_device"]
    assert rec["host_syncs"] == 0
    # the state a position holds, held to the reference's shapes
    jcfg = j_configs.load_config("deepseek-moe-16b", smoke=True)
    shape = j_base.ShapeConfig("train_4k", 64, 8, "train", 4)
    mesh = jax.sharding.Mesh(np.array(jax.devices() * 8)[:8].reshape(
        2, 2, 2), ("pod", "data", "model"))
    rules = j_steps.rules_for(mesh, shape)
    dp = int(np.prod([mesh.shape[a] for a in rules.batch]))
    jcfg = j_steps.adapt_config(jcfg, shape, dp)
    params_abs = j_tfm.abstract_params(jcfg)
    p_shard = j_steps.param_shardings(jcfg, mesh, rules)
    opt = j_steps.optimizer_for(jcfg, j_base.TrainConfig())
    opt_abs = jax.eval_shape(opt.init, params_abs)
    want = (j_dryrun._tree_bytes_per_device(
        j_dryrun._with_shardings(params_abs, p_shard))
        + j_dryrun._tree_bytes_per_device(j_dryrun._with_shardings(
            opt_abs, j_steps.opt_shardings(opt_abs, params_abs, p_shard,
                                           mesh, rules))))
    assert rec["state_bytes_per_device"] == want
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want


def test_cli_prints_the_record(monkeypatch, capsys, tmp_path):
    _small_mesh_cell(monkeypatch)
    out = tmp_path / "rec.json"
    assert t_dryrun.main(["--arch", "starcoder2-3b", "--shape", "train_4k",
                          "--mesh", "single", "--out", str(out)]) == 0
    assert '"status": "ok"' in capsys.readouterr().out
    assert '"mesh": "16x16"' in out.read_text()
    # a full-attention arch at 500k positions is skipped, exit 0
    assert t_dryrun.main(["--arch", "starcoder2-3b", "--shape",
                          "long_500k"]) == 0
    assert '"skipped"' in capsys.readouterr().out


def test_retrieval_decode_cell_traces_the_head(monkeypatch):
    """The decode cell with the kNN-LM head over the reference's
    131,072 x 48 store on meta rows, calibrated on the host."""
    _small_mesh_cell(monkeypatch)
    monkeypatch.setattr(t_dryrun, "RETRIEVAL_CAPACITY", 4096)
    shapes = dict(t_dryrun.SHAPES)
    shapes["decode_32k"] = ShapeConfig("decode_32k", 64, 8, "decode")
    monkeypatch.setattr(t_dryrun, "SHAPES", shapes)
    plain = t_dryrun.run_cell("starcoder2-3b", "decode_32k", False)
    head = t_dryrun.run_cell("starcoder2-3b", "decode_32k", False,
                             retrieval=True)
    assert plain["status"] == head["status"] == "ok"
    # the head's (B, 4d) x (4d, N) product over the store
    assert head["flops_total"] - plain["flops_total"] >= 2 * 8 * 192 * 4096
    assert head["state_bytes_per_device"] == plain["state_bytes_per_device"]
