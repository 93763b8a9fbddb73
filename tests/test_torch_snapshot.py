"""Port parity: index snapshots load across the two packages.

A snapshot saved by the JAX package loads in the port, and one saved by
the port loads in the JAX package, for pristine float32, pristine compact
and live (mid-buffer, with tombstones) indexes on the mqr-tree, the R-tree
and the pyramid.  The loaded index gives the saver's hits and per-level
visits (compact visits are the compact sweep's own, so they are compared
with a compact sweep of the saver), its live ids and its id space, and a
port load installs the saved tiles without quantizing again.  The version
and not-a-snapshot errors are the reference's.

Sizes are the reference tests' (tests/test_durability.py).  The JAX
package answers on its ``host`` backend, and on ``pallas`` (interpret
mode) where a compact sweep's visits are compared.

Tolerance: exact — boolean masks and integer counts.
"""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint import SnapshotError as JaxSnapshotError
from repro.core import datasets
from repro.index import SpatialIndex as JaxIndex
from repro_torch import SpatialIndex
from repro_torch.checkpoint import FORMAT_VERSION, SnapshotError, snapshot_meta
from repro_torch.checkpoint import spatial as pspatial

STRUCTURES = ("mqr", "rtree", "pyramid")
STATES = ("pristine", "compact", "live")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _data():
    return datasets.uniform_squares(120, seed=0)


def _queries():
    return datasets.region_queries(_data(), 16, seed=1).astype(np.float32)


def _opts(structure, state):
    opts = {"build": "device"} if structure == "pyramid" else {}
    if state == "compact":
        opts["precision"] = "compact"
    if state == "live":
        opts["capacity"] = 24
    return opts


def _mutate(idx):
    idx.insert(datasets.uniform_squares(7, seed=3))
    idx.delete([2, 5, 121])


def _jax_saver(structure, state):
    backend = "pallas" if state == "compact" else "host"
    kw = {"autotune": "off"} if backend == "pallas" else {}
    idx = JaxIndex.build(_data(), structure=structure, backend=backend,
                         **_opts(structure, state), **kw)
    if state == "live":
        _mutate(idx)
    return idx


def _port_saver(structure, state):
    idx = SpatialIndex.build(_data(), structure=structure, device="cpu",
                             **_opts(structure, state))
    if state == "live":
        _mutate(idx)
    return idx


def _same(res, hits, visits):
    assert np.array_equal(_np(res.hits), _np(hits))
    assert np.array_equal(_np(res.visits_per_level), _np(visits))


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_jax_snapshot_loads_in_the_port(tmp_path, structure, state):
    saver = _jax_saver(structure, state)
    ref = saver.region(_queries())
    saver.save(tmp_path / "s")
    prec = {"precision": "compact"} if state == "compact" else {}
    loaded = SpatialIndex.load(tmp_path / "s", device="cpu", **prec)
    _same(loaded.region(_queries()), ref.hits, ref.visits_per_level)
    assert loaded.n_objects == saver.n_objects and loaded.id_space == saver.id_space
    if state == "compact":
        # the saved tiles are installed as they are
        assert loaded.artifacts._quantized is not None
        assert np.array_equal(_np(loaded.artifacts.quantized.mbr_q),
                              np.asarray(saver.artifacts.quantized.mbr_q))
    else:
        host = SpatialIndex.load(tmp_path / "s", backend="host", device="cpu")
        _same(host.region(_queries()), ref.hits, ref.visits_per_level)
    if state == "live":
        assert np.array_equal(loaded._updates.alive, saver._updates.alive)
        batch = datasets.uniform_squares(4, seed=7)
        assert np.array_equal(loaded.insert(batch), saver.insert(batch))


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_port_snapshot_loads_in_the_jax_package(tmp_path, structure, state):
    saver = _port_saver(structure, state)
    ref = saver.region(_queries())
    saver.save(tmp_path / "s")
    meta = json.loads((tmp_path / "s" / "meta.json").read_text())
    assert meta["format_version"] == FORMAT_VERSION and meta["backend"] == "cuda"
    if state == "compact":
        loaded = JaxIndex.load(tmp_path / "s", backend="pallas", precision="compact",
                               autotune="off")
        assert loaded.artifacts._quantized is not None
    else:
        loaded = JaxIndex.load(tmp_path / "s", backend="host")
    _same(loaded.region(_queries()), ref.hits, ref.visits_per_level)
    assert loaded.n_objects == saver.n_objects and loaded.id_space == saver.id_space
    if state == "live":
        batch = datasets.uniform_squares(4, seed=7)
        assert np.array_equal(loaded.insert(batch), saver.insert(batch))
        _same(loaded.region(_queries()), *(lambda r: (r.hits, r.visits_per_level))(
            saver.with_backend("host").region(_queries())))


def test_snapshot_arrays_match_the_reference_keys_and_dtypes(tmp_path):
    """The same index saved by both packages holds the same npz keys,
    dtypes and shapes, and equal arrays."""
    for pkg, build in (("jax", _jax_saver), ("port", _port_saver)):
        build("pyramid", "live").save(tmp_path / pkg)
    with np.load(tmp_path / "jax" / "arrays.npz") as j, \
            np.load(tmp_path / "port" / "arrays.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            assert np.array_equal(j[k], p[k]), k


def test_load_builds_nothing(tmp_path, monkeypatch):
    """A load installs the saved schedule: no pyramid build and no
    quantization runs (on the card: no kernel #4 or #5 launch)."""
    saver = _port_saver("pyramid", "compact")
    saver.save(tmp_path / "s")
    from repro_torch.kernels import ops

    def forbidden(*a, **k):
        raise AssertionError("load must not build or quantize")

    monkeypatch.setattr(ops, "device_schedule", forbidden)
    monkeypatch.setattr(ops, "quantize_schedule", forbidden)
    loaded = SpatialIndex.load(tmp_path / "s", device="cpu", precision="compact")
    assert torch.equal(loaded.region(_queries()).hits, saver.region(_queries()).hits)


def test_unknown_version_rejected_by_both(tmp_path):
    SpatialIndex.build(datasets.uniform_squares(20, seed=0), backend="host",
                       device="cpu").save(tmp_path / "s")
    meta = json.loads((tmp_path / "s" / "meta.json").read_text())
    meta["format_version"] = 99
    (tmp_path / "s" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(SnapshotError, match="format 99"):
        SpatialIndex.load(tmp_path / "s", backend="host", device="cpu")
    with pytest.raises(JaxSnapshotError):
        JaxIndex.load(tmp_path / "s", backend="host")
    assert snapshot_meta(tmp_path / "s") is None


def test_not_a_snapshot_rejected(tmp_path):
    with pytest.raises(SnapshotError, match="not a spatial-index snapshot"):
        SpatialIndex.load(tmp_path / "empty", backend="host", device="cpu")
    (tmp_path / "half").mkdir()
    (tmp_path / "half" / "meta.json").write_text("{}")
    with pytest.raises(SnapshotError):
        pspatial.read_state(tmp_path / "half")


def test_save_is_atomic_and_supersedes(tmp_path):
    """A second save replaces the first only once it is complete, and
    leaves no temporary directory behind."""
    a = _port_saver("pyramid", "pristine")
    a.save(tmp_path / "s")
    b = _port_saver("pyramid", "live")
    b.save(tmp_path / "s")
    assert [p.name for p in tmp_path.iterdir()] == ["s"]
    assert snapshot_meta(tmp_path / "s")["has_updates"]
