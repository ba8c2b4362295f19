"""The plain versions of the port's probes P1-P3 against the TPU probes'
own semantics on the CPU, with inputs made from seeds:

* P1 (chunk stream) against ``tools/spike_dma.py``'s ``run`` in Pallas
  interpret mode, loaded by path, and its numpy loop. The kernel's
  reduction order is its own (256 lane partials, then shuffle trees over
  warps), so the sums agree within the probe's rtol 1e-5, not bit for bit;
  that order itself is held bit for bit against a numpy model of the CUDA
  kernel's adds;
* P2 (transpose) against the probe's ``xla3d`` variant,
  ``x3.transpose(0, 2, 1).reshape(V * N, R)``: equal;
* P3 (shared-memory gather) against ``jnp.take_along_axis`` in a
  ``fori_loop``, both axes, at a small T and at T = 400 with indices that
  wrap: the adds run in the same order, so equal.

Each wrapper takes the plain version for CPU tensors and counts no launch;
the CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldrenderer_tpu_torch.probes import chunk_stream as p1
from worldrenderer_tpu_torch.probes import smem_gather as p3
from worldrenderer_tpu_torch.probes import transpose as p2

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: beside other test processes on the same cores,
    the intra-op threads of the plain versions' gathers would wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _p1_case(seed):
    """Seed 0: the TPU probe's own case (2 views x 4 tiles of 16 x 128,
    chunks of 128). Otherwise random runs over a (3, 8, 16c) array: empty,
    overlapping and end-of-array runs."""
    if seed == 0:
        x = np.arange(2 * 8 * 1024, dtype=np.float32).reshape(2, 8, 1024) * 1e-4
        starts = np.array([[0, 2, 4, 6], [1, 3, 5, 7]], np.int32)
        nch = np.array([[2, 2, 2, 0], [1, 1, 1, 1]], np.int32)
        return x, starts, nch, (4, 16, 128, 128)
    rng = np.random.default_rng(seed)
    c, n_tiles = 128, 6
    x = rng.random((3, 8, 16 * c)).astype(np.float32)
    starts = rng.integers(0, 16, (3, n_tiles)).astype(np.int32)
    nch = np.minimum(rng.integers(0, 6, (3, n_tiles)), 16 - starts).astype(np.int32)
    nch[0, 0] = 0
    return x, starts, nch, (n_tiles, 8, 64, c)


def _p1_numpy(x, starts, nch, n_tiles, th, tw, c):
    """The probe's numpy loop (tools/spike_dma.py:88-98)."""
    out = np.zeros((x.shape[0], n_tiles * th, tw), np.float32)
    for b in range(x.shape[0]):
        for i in range(n_tiles):
            acc = np.float32(0.0)
            for ci in range(int(nch[b, i])):
                s = (int(starts[b, i]) + ci) * c
                acc += x[b, :, s:s + c].sum(dtype=np.float32)
            out[b, i * th:(i + 1) * th] = acc + np.arange(
                th * tw, dtype=np.float32).reshape(th, tw)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_stream_matches_the_tpu_probe(seed):
    x, starts, nch, dims = _p1_case(seed)
    before = p1.launch_count
    got = p1.chunk_stream(torch.from_numpy(x), torch.from_numpy(starts),
                          torch.from_numpy(nch), *dims).numpy()
    assert p1.launch_count == before  # the CPU path does not launch
    n_tiles, th, tw, c = dims
    want = np.asarray(_tool("spike_dma").run(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(nch), n_tiles, th, tw,
        True))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, _p1_numpy(x, starts, nch, *dims), rtol=1e-5)


def _p1_kernel_order(x, starts, nch, n_tiles, th, tw, c):
    """The CUDA kernel's order of adds, written out in numpy: lane t sums
    its four-float pieces t, t + 256, ... of each chunk in run order, then
    shuffle trees over each warp's 32 lanes and over the 8 warp sums."""
    out = np.zeros((x.shape[0], n_tiles * th, tw), np.float32)
    for b in range(x.shape[0]):
        for i in range(n_tiles):
            lanes = np.zeros(256, np.float32)
            for ci in range(int(nch[b, i])):
                s = (int(starts[b, i]) + ci) * c
                flat = x[b, :, s:s + c].reshape(-1)
                for q in range(0, flat.size, 1024):
                    piece = flat[q:q + 1024].reshape(-1, 4)
                    for k in range(4):
                        lanes[:piece.shape[0]] += piece[:, k]
            warps = lanes.reshape(8, 32)
            for k in (16, 8, 4, 2, 1):
                warps = warps[:, :k] + warps[:, k:2 * k]
            tot = warps[:, 0]
            for k in (4, 2, 1):
                tot = tot[:k] + tot[k:2 * k]
            out[b, i * th:(i + 1) * th] = tot[0] + np.arange(
                th * tw, dtype=np.float32).reshape(th, tw)
    return out


@pytest.mark.parametrize("case", ["long_runs", "all_empty", "c256", "c32"])
def test_chunk_stream_runs_the_kernel_order(case):
    """The plain version adds as the CUDA kernel does, bit for bit, and
    stays within the probe's rtol 1e-5 of the TPU probe's sums: runs of 9
    to 14 chunks, longer than the kernel's group of 4 chunks held in
    registers; every count 0 (iota alone); chunks of 256 (two pieces a
    lane) and of 32 (64 lanes of 256 load)."""
    rng = np.random.default_rng(7)
    c = {"c256": 256, "c32": 32}.get(case, 128)
    n_tiles, th, tw = 5, 8, 64
    # Values in [0, 1), like the probe's own: sums without cancellation,
    # which the relative tolerance assumes.
    x = rng.random((2, 8, 40 * c)).astype(np.float32)
    starts = rng.integers(0, 20, (2, n_tiles)).astype(np.int32)
    nch = rng.integers(9, 15, (2, n_tiles)).astype(np.int32)
    if case == "all_empty":
        nch[:] = 0
    got = p1.chunk_stream(torch.from_numpy(x), torch.from_numpy(starts),
                          torch.from_numpy(nch), n_tiles, th, tw, c).numpy()
    np.testing.assert_array_equal(
        got, _p1_kernel_order(x, starts, nch, n_tiles, th, tw, c))
    np.testing.assert_allclose(
        got, _p1_numpy(x, starts, nch, n_tiles, th, tw, c), rtol=1e-5)
    if case == "all_empty":
        assert (got == np.arange(th * tw, dtype=np.float32).reshape(th, tw)
                .reshape(1, th, tw).repeat(n_tiles, 0).reshape(n_tiles * th, tw)).all()


def test_chunk_stream_entry_point_runs_on_the_cpu(capsys):
    assert p1.main(["--device", "cpu"]) == 0
    assert "chunk_stream OK on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(2, 24, 1001), (1, 5, 7), (3, 64, 130)])
def test_transpose_matches_the_tpu_probe(shape):
    x3 = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    v, r, n = shape
    want = np.asarray(jnp.asarray(x3).transpose(0, 2, 1).reshape(v * n, r))
    before = p2.launch_count
    got = p2.transpose(torch.from_numpy(x3))
    assert p2.launch_count == before
    np.testing.assert_array_equal(got.numpy(), want)
    if v * n > 123 and r > 7:  # the probe's checksum reads row 123, column 7
        assert p2.checksum(got) == pytest.approx(
            float(want[::797].sum() + want[-3:].sum() + want[123, 7]), abs=1e-4)


@pytest.mark.parametrize("axis", [0, 1])
def test_smem_gather_matches_the_tpu_probe(axis):
    rows, t_reps = 64, 9
    x, idx = p3.probe_inputs(axis, "cpu", rows=rows)
    m = rows if axis == 0 else p3.LANES

    def body(i, acc):
        return acc + jnp.take_along_axis(
            jnp.asarray(x.numpy()), jnp.remainder(jnp.asarray(idx.numpy()) + i, m),
            axis=axis)

    want = np.asarray(jax.lax.fori_loop(0, t_reps, body,
                                        jnp.zeros((rows, p3.LANES), jnp.float32)))
    before = p3.launch_count
    got = p3.smem_gather(x, idx, t_reps, axis)
    assert p3.launch_count == before
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rows, start", [(300, "last"), (300, "zero"),
                                         (5, "last"), (37, "random")])
def test_smem_gather_wraps_as_the_tpu_probe(axis, rows, start):
    """The wrap of (idx0 + i) mod M with M = rows (axis 0; no power of two,
    and 5, fewer than the kernel's group of 16 loads) or 128 (axis 1): idx0
    at M - 1, at 0 or random, T = 400 steps, so every element wraps more
    than once at 300 rows; against ``take_along_axis`` in a ``fori_loop``,
    bit for bit."""
    t_reps = 400
    rng = np.random.default_rng(rows)
    x = rng.random((rows, p3.LANES)).astype(np.float32)
    m = rows if axis == 0 else p3.LANES
    idx = {"last": np.full((rows, p3.LANES), m - 1),
           "zero": np.zeros((rows, p3.LANES)),
           "random": rng.integers(0, m, (rows, p3.LANES))}[start].astype(np.int32)

    def body(i, acc):
        return acc + jnp.take_along_axis(
            jnp.asarray(x), jnp.remainder(jnp.asarray(idx) + i, m), axis=axis)

    want = np.asarray(jax.lax.fori_loop(0, t_reps, body,
                                        jnp.zeros((rows, p3.LANES), jnp.float32)))
    got = p3.smem_gather(torch.from_numpy(x), torch.from_numpy(idx), t_reps, axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8, 1024))
    s = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        p1.chunk_stream(x, s, s, 4, 16, 128, c=100)  # c not a multiple of 32
    with pytest.raises(TypeError):
        p1.chunk_stream(x, s.long(), s, 4, 16, 128)
    with pytest.raises(ValueError):
        p1.chunk_stream(x[:, :4], s, s, 4, 16, 128)
    with pytest.raises(ValueError):
        p2.transpose(torch.zeros((2, 65, 3)))  # more rows than the tile takes
    with pytest.raises(ValueError):
        p2.transpose(torch.zeros((2, 3, 4)).transpose(1, 2))
    with pytest.raises(ValueError):
        p3.smem_gather(torch.zeros((4, 64)), torch.zeros((4, 64), dtype=torch.int32),
                       2, 0)
    with pytest.raises(ValueError):
        p3.smem_gather(torch.zeros((4, 128)), torch.zeros((4, 128), dtype=torch.int32),
                       2, 2)
