"""The port's ``utils`` against the JAX package's on the CPU: the config
system (tests/test_utils.py's YAML, resolver and dotlist cases through both
packages), checkpoints loaded both ways and into an ``nn.Module``, the span
profiler, rank gating of the logger, the debug helpers, the roofline's trace
parser and work counts, the validate gates, and a fresh interpreter that
imports every module of the port and finds no JAX.

Torch and numpy run on one thread."""

import gzip
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr
import worldrenderer_tpu.utils as jutils
from worldrenderer_tpu.utils import config as jconfig
from worldrenderer_tpu.utils import misc as jmisc
from worldrenderer_tpu.utils import roofline as jroofline

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.utils as putils
from worldrenderer_tpu_torch.utils import config as pconfig
from worldrenderer_tpu_torch.utils import debug as pdebug
from worldrenderer_tpu_torch.utils import misc as pmisc
from worldrenderer_tpu_torch.utils import roofline as proofline
from worldrenderer_tpu_torch.utils import validate as pvalidate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def test_utils_exports_the_reference_names():
    assert set(jutils.__all__) <= set(putils.__all__)
    assert "parallel" in pt.__all__ and pt.parallel.__all__ == wr.parallel.__all__


# ---- config ----------------------------------------------------------------------


def _yaml_pair(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("name: exp\nseed: 1\ndata: {batch: 4, res: 64}\n"
                    "trainer: {lr: '${div:${data.res},32}'}\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"extends: {base}\ndata: {{res: 128}}\ntag: t\n")
    return child


_CONFIG_CASES = {
    "resolvers": lambda m, tmp: m.resolve({
        "a": 4, "b": "${mul:${a},3}", "c": "${idiv:${b},5}",
        "d": "${not:${gt0:${a}}}", "e": "${basename:/x/y/z.png}",
        "f": "${rmspace:a b c,_}", "g": "${tuple2:0.5}",
        "h": "${calc_exp_lr_decay_rate:0.1,100}", "i": "${sub:${a},1.5}",
        "steps": "${calc_num_train_steps:1024,4,10,1,8}",
        "s": "run-${a}-${b}"}),
    "dotlist": lambda m, tmp: m.from_dotlist(
        ["a.b=1", "a.c=true", "x=hello", "y=1.5", "z=[1, 2]", "n=null"]),
    "merge": lambda m, tmp: m.merge_dicts({"a": {"b": 1, "c": 2}},
                                          {"a": {"c": 3}, "d": 4}),
    "load": lambda m, tmp: m.load_config(
        str(_yaml_pair(tmp)), cli_args=["data.batch=8", "seed=7"],
        makedirs=False, exp_root_dir=str(tmp / "out"),
        use_timestamp=False).__dict__,
    "load_string": lambda m, tmp: m.load_config(
        "name: s\ntag: x\ntrainer: {steps: '${mul:2,5}'}\n", from_string=True,
        makedirs=False, use_timestamp=False, exp_root_dir=str(tmp)).__dict__,
}


@pytest.mark.parametrize("case", sorted(_CONFIG_CASES))
def test_config_matches_jax(case, tmp_path):
    """tests/test_utils.py's config cases, and more resolvers, through both
    packages: equal results."""
    want = _CONFIG_CASES[case](jconfig, tmp_path)
    got = _CONFIG_CASES[case](pconfig, tmp_path)
    assert got == want


def test_config_errors_and_dump(tmp_path):
    """Unknown keys and resolvers raise as in the JAX package; a dumped
    config reads back as the JAX package dumps it."""
    with pytest.raises(ValueError, match="unknown config keys"):
        pconfig.parse_structured(pconfig.ExperimentConfig, {"nope": 1})
    with pytest.raises(KeyError, match="unknown config resolver"):
        pconfig.resolve({"a": "${nosuch:1}"})
    with pytest.raises(ValueError, match="tag is specified"):
        pconfig.load_config("name: a\n", from_string=True, makedirs=False,
                            use_timestamp=False)
    cfg = pconfig.load_config("name: d\ntag: t\n", from_string=True,
                              makedirs=False, exp_root_dir=str(tmp_path))
    pconfig.dump_config(str(tmp_path / "p.yaml"), cfg)
    jconfig.dump_config(str(tmp_path / "j.yaml"), cfg)
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    putils.ConfigSnapshotCallback(cfg, str(tmp_path / "snap")).setup()
    assert (tmp_path / "snap" / "parsed.yaml").read_text() == (
        tmp_path / "j.yaml").read_text()
    for mod, name in ((putils, "p.txt"), (jutils, "j.txt")):
        mod.ProgressCallback(str(tmp_path / name), total_steps=8).on_step(3, "x")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_scalar_schedule_matches_jax():
    for args in ((2.5, 0, 0), ([0, 0.0, 1.0, 10], 0, 5), ([0, 0.0, 1.0, 10], 0, 20),
                 ([1.0, 0.0, 10], 0, 5), ([0, 0.0, 1.0, 10.0], 5, 99999)):
        assert pmisc.C(*args) == jmisc.C(*args)


# ---- checkpoints -------------------------------------------------------------------


def test_checkpoints_load_both_ways(tmp_path):
    """A checkpoint the JAX package writes loads in the port and the other
    way round, arrays and counters equal; the port writes tensors as their
    numpy values; load_module_weights selects, ignores and remaps keys as
    the JAX package's does."""
    rng = np.random.default_rng(3)
    state = {"tex": rng.random((4, 4, 3)).astype(np.float32),
             "opt": {"mu": rng.random(3), "count": np.asarray(7, np.int32)}}
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jmisc.save_checkpoint(jpath, {"tex": jnp.asarray(state["tex"]),
                                  "opt": state["opt"]}, epoch=2, global_step=100)
    pmisc.save_checkpoint(ppath, {"tex": torch.from_numpy(state["tex"]),
                                  "opt": state["opt"]}, epoch=2, global_step=100)
    for path in (jpath, ppath):
        for load in (jmisc.load_checkpoint, pmisc.load_checkpoint):
            loaded, epoch, step = load(path)
            assert (epoch, step) == (2, 100)
            np.testing.assert_array_equal(loaded["tex"], state["tex"])
            np.testing.assert_array_equal(loaded["opt"]["mu"], state["opt"]["mu"])
            assert loaded["opt"]["count"] == 7
    for kw in (dict(module_name="opt"), dict(ignore_modules=["opt"]),
               dict(mapping=[{"from": "opt.", "to": "optim."}])):
        got, want = (m.load_module_weights(jpath, **kw)[0] for m in (pmisc, jmisc))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_load_module_weights_into_a_module(tmp_path):
    """The JAX package's checkpoint of a module's parameters loads into an
    nn.Module under its submodule name; BaseObject's ``weights:`` config
    restores its params from the same file."""
    net = torch.nn.Linear(3, 2)
    rng = np.random.default_rng(4)
    w = rng.random((2, 3)).astype(np.float32)
    b = rng.random(2).astype(np.float32)
    path = str(tmp_path / "net.npz")
    jmisc.save_checkpoint(path, {"net": {"weight": w, "bias": b}}, global_step=5)
    flat, _, step = pmisc.load_module_weights(path, module_name="net", module=net)
    assert step == 5 and sorted(flat) == ["bias", "weight"]
    np.testing.assert_array_equal(net.weight.detach().numpy(), w)
    np.testing.assert_array_equal(net.bias.detach().numpy(), b)

    seen = []

    class Obj(putils.BaseObject):
        def update_step(self, epoch, global_step, on_load_weights=False):
            seen.append((global_step, on_load_weights))

    obj = Obj({"weights": f"{path}:net"})
    np.testing.assert_array_equal(obj.params["weight"], w)
    assert seen == [(5, True)]


def test_updateable_recursion_children_first():
    calls = []

    class Child(putils.BaseObject):
        def update_step(self, epoch, step, on_load_weights=False):
            calls.append(("child", epoch, step))

    class Parent(putils.BaseObject):
        def configure(self):
            self.child = Child()
            self._hidden = Child()

        def update_step(self, epoch, step, on_load_weights=False):
            calls.append(("parent", epoch, step))

    putils.update_if_possible(Parent(), 2, 7)
    assert calls == [("child", 2, 7), ("parent", 2, 7)]


# ---- misc, logging, debug ------------------------------------------------------------


def test_rank_logging_and_memory_stats(monkeypatch):
    """get_rank reads the env's rank; the library logger is silent on rank 1
    and speaks on rank 0; without a card the memory stats are empty."""
    import io
    import logging as pylog

    from worldrenderer_tpu_torch.utils import logging as wlog

    monkeypatch.setenv("RANK", "1")
    assert pmisc.get_rank() == 1
    logger = wlog.get_logger("rank_test")
    buf = io.StringIO()
    handler = pylog.StreamHandler(buf)
    wlog.add_handler(handler)
    try:
        wlog.set_verbosity_info()
        logger.info("from rank 1")
        monkeypatch.setenv("RANK", "0")
        logger.info("from rank 0")
    finally:
        wlog.remove_handler(handler)
        wlog.set_verbosity_warning()
    assert "from rank 1" not in buf.getvalue() and "from rank 0" in buf.getvalue()
    assert logger.name == "worldrenderer_tpu_torch.rank_test"
    monkeypatch.delenv("RANK")
    for key in ("LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert pmisc.get_rank() == 0
    if not torch.cuda.is_available():
        assert pmisc.device_memory_stats() == {}


def test_time_recorder_and_find():
    rec = pmisc.TimeRecorder()
    assert rec is pmisc.time_recorder
    with pmisc.time_recorder_enabled():
        rec.start("span", block_on=torch.ones(3))
        assert rec.end("span", accumulate=True, block_on=[torch.ones(2)]) >= 0.0
        assert rec.get_accumulation("span", average=True) >= 0.0
    assert rec.end("span") is None
    assert pmisc.find("worldrenderer_tpu_torch.utils.misc.TimeRecorder") is pmisc.TimeRecorder


def test_debug_helpers(tmp_path):
    """check_finite passes finite trees and names the bad leaf; debug_nans
    raises on a NaN gradient; trace writes a Chrome trace holding an
    annotate span."""
    x = {"a": torch.ones(3), "b": [torch.zeros(2), 1]}
    assert pdebug.check_finite(x, "x") is x
    with pytest.raises(FloatingPointError, match=r"x\.b\[0\]"):
        pdebug.check_finite({"a": torch.ones(3), "b": [torch.tensor([np.nan])]},
                            "x")
    with pdebug.debug_nans():
        assert torch.is_anomaly_enabled()
        v = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(v).sum().backward()
    assert not torch.is_anomaly_enabled()
    with pdebug.trace(str(tmp_path / "tr")) as d:
        with pdebug.annotate("my_span"):
            torch.ones(8).sum()
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)


def test_typing_names():
    from worldrenderer_tpu.utils import typing as jt

    from worldrenderer_tpu_torch.utils import typing as ptyping

    assert ptyping.HAS_JAXTYPING == jt.HAS_JAXTYPING
    if ptyping.HAS_JAXTYPING:
        typeguard = pytest.importorskip("typeguard")

        @ptyping.jaxtyped(typechecker=typeguard.typechecked)
        def f(p: ptyping.Float[torch.Tensor, "n 3"]) -> ptyping.Float[torch.Tensor, "n 3"]:
            return p * 2.0

        assert f(torch.ones(5, 3)).shape == (5, 3)
        with pytest.raises(Exception):
            f(torch.ones(5, 2))


# ---- roofline ----------------------------------------------------------------------------


def _write_trace(path, events, gz):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_exclusive_times_nested_matches_jax(tmp_path):
    """tests/test_roofline.py's nested device events: the port's parser
    gives the JAX package's times, and skips host events."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "parent", "ts": 0, "dur": 100},
        {"ph": "X", "pid": 1, "tid": 1, "name": "child", "ts": 10, "dur": 30},
        {"ph": "X", "pid": 1, "tid": 1, "name": "child2", "ts": 50, "dur": 10},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "python host"}},
        {"ph": "X", "pid": 2, "tid": 1, "name": "host_op", "ts": 0, "dur": 500},
    ]
    p = tmp_path / "t.trace.json.gz"
    _write_trace(p, events, gz=True)
    got, want = proofline.exclusive_times(str(p)), jroofline.exclusive_times(str(p))
    assert dict(got) == pytest.approx(dict(want)) and "host_op" not in got


def test_exclusive_times_overlap_never_negative(tmp_path):
    """A torch.profiler-style trace (kernels on a stream lane, a host op
    beside them) where a child outlasts its parent and two children
    overlap: every exclusive time is >= 0, the child counted inside the
    parent's span only (the JAX package's parser would give
    gbuffer_tiles 60 - 70 us), and the host op skipped."""
    events = [
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "name": "span", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "gbuffer_tiles",
         "ts": 10, "dur": 60},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k2",
         "ts": 20, "dur": 70},
        {"ph": "X", "cat": "cpu_op", "pid": 99, "tid": 1, "name": "aten::add",
         "ts": 0, "dur": 5},
    ]
    p = tmp_path / "trace.json"
    _write_trace(p, events, gz=False)
    ex = proofline.exclusive_times(str(p))
    assert all(v >= 0 for v in ex.values()) and "aten::add" not in ex
    assert ex["span"] == pytest.approx(10e-6)
    assert ex["gbuffer_tiles"] == pytest.approx(10e-6)
    assert ex["k2"] == pytest.approx(70e-6)


def test_kernel_counts_match_jax():
    """tests/test_roofline.py's heightfield (48², 2 views at 128² under
    auto_fast_config): the port's live entries and chunk trips equal the
    JAX package's; the work model counts K1's instructions."""
    from worldrenderer_tpu.mesh import TexturedMesh, make_grid_mesh
    from worldrenderer_tpu.ops.rasterize import auto_fast_config
    from worldrenderer_tpu.transforms import get_clip_space_position

    verts, faces = make_grid_mesh(
        48, extent=1.0, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    mesh = TexturedMesh(v_pos=jnp.asarray(verts, jnp.float32),
                        t_pos_idx=jnp.asarray(faces, jnp.int32))
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=2, near=0.1, far=10.0)
    pos = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = auto_fast_config(pos, mesh.t_pos_idx, (128, 128))
    want = jroofline.kernel_counts(pos, mesh.t_pos_idx, (128, 128), cfg)
    ppos = torch.from_numpy(np.array(pos))
    got = proofline.kernel_counts(ppos, torch.from_numpy(np.asarray(faces, np.int64)),
                                  (128, 128), pt.config_from_dict(cfg._asdict()))
    for k in want:
        assert got[k] == want[k], k
    useful, issued = proofline.kernel_flops(got)
    per_entry = got["pixels_per_tile"] * 17 + got["tile_h"] * 4
    assert useful == got["live_entries"] * per_entry
    assert issued == got["chunk_trips"] * got["chunk"] * per_entry >= useful
    assert proofline.H100_PEAK_FP32_INSTR == 33.5e12
    assert proofline.measure_kernel_mfu(lambda i: None, got) is None or \
        torch.cuda.is_available()


def test_k1_bound_on_plain_inputs():
    """k1_bound_ms on the headline-sized K1 inputs of a small scene: the
    larger of the instruction and byte times, from the live chunks."""
    from worldrenderer_tpu_torch.ops import gbuffer as gb

    verts, faces = pt.make_grid_mesh(
        48, extent=1.0, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    mesh = pt.mesh_from_arrays(verts, faces, device="cpu")
    cam = pt.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=2, near=0.1, far=10.0, device="cpu")
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, mesh.t_pos_idx, (128, 128))
    inputs, dims, _ = gb._k1_inputs(pos, mesh.t_pos_idx, None, 128, 128, cfg)
    ms, by, live = proofline.k1_bound_ms(inputs, dims)
    n_vals, th, tw = dims[:3]
    ops_ms = live * dims[5] * th * (tw * 17 + 4) / 33.5e12 * 1e3
    assert live == int(inputs[3].sum()) > 0 and by in ("operations", "bytes")
    assert ms >= ops_ms and (by != "operations" or ms == ops_ms)


# ---- validate ---------------------------------------------------------------------------


def test_validate_gates_pass_on_the_cpu():
    """precision_gate (K1 against K3, both plain versions here) and
    degenerate_probes pass at 64² (the gate's p99.9 bounds need the pixels:
    at 48² the icosphere's p99.9 |dz| is its largest, 1.5e-4)."""
    gate = pvalidate.precision_gate(res=64, quiet=True, device="cpu")
    assert gate["ok"], gate["scenes"]
    assert len(gate["scenes"]) == 3
    probes = pvalidate.degenerate_probes(res=64, quiet=True, device="cpu")
    assert probes["ok"], probes["probes"]


# ---- imports ------------------------------------------------------------------------------


def test_every_module_imports_without_jax():
    """A fresh interpreter imports every module of the port, utils.typing
    and parallel included, and finds neither jax nor worldrenderer_tpu in
    sys.modules (nor PyYAML, which only load_config and dump_config take)."""
    import worldrenderer_tpu_torch

    names = sorted(m.name for m in pkgutil.walk_packages(
        worldrenderer_tpu_torch.__path__, "worldrenderer_tpu_torch."))
    assert "worldrenderer_tpu_torch.utils.typing" in names
    assert "worldrenderer_tpu_torch.parallel.bake" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'worldrenderer_tpu.')) or m in "
            "('worldrenderer_tpu', 'yaml'))\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
