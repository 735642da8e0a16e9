#
# The PyTorch port's device pool and row layouts (spark_rapids_ml_tpu_torch/
# parallel/mesh.py) against the JAX package's parallel/mesh.py on the same
# calls: the JAX side on conftest's eight virtual CPU devices, the port on
# `set_devices(["cpu"] * 8)`, eight chips on the host. A chip's id is its
# position in the pool on both sides (the CPU devices' ids are 0-7), so the
# two meshes are compared as grids of chip ids, exactly. The counterparts of
# tests/test_parallel.py's mesh tests (get_mesh's typed refusals,
# build_mesh flat and 2-D, its bad topologies and the JAX config knob (an
# argument in the port), submesh and survivor_mesh, chip_scope local to its
# context and thread) and of shard_row_slices' ranges. The port places no padding rows: its blocks are
# the JAX blocks' valid rows.
#
import threading

import numpy as np
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu.errors import MeshTopologyError as JaxMeshTopologyError
from spark_rapids_ml_tpu.parallel import mesh as jmesh
from spark_rapids_ml_tpu_torch import core as tcore
from spark_rapids_ml_tpu_torch import parallel
from spark_rapids_ml_tpu_torch.errors import MeshTopologyError, SrmlError
from spark_rapids_ml_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def _pool():
    parallel.set_devices(["cpu"] * 8)
    yield
    parallel.set_devices(None)


def _jax_ids(m) -> np.ndarray:
    return np.vectorize(lambda d: int(d.id))(m.devices)


def _port_ids(m) -> np.ndarray:
    return m.ids_grid()


def test_get_mesh_refusals_are_typed_as_jax_refuses():
    assert len(jmesh.default_devices()) == 8 and len(tmesh.default_devices()) == 8
    for bad in (3, 0, 16, -1):
        with pytest.raises(JaxMeshTopologyError) as je:
            jmesh.get_mesh(bad)
        with pytest.raises(MeshTopologyError) as te:
            tmesh.get_mesh(bad)
        assert isinstance(te.value, SrmlError) and isinstance(te.value, ValueError)
        assert (te.value.requested, te.value.available) == (je.value.requested, je.value.available)
    with pytest.raises(MeshTopologyError, match=r"num_workers=3 .*8-device"):
        tmesh.get_mesh(3)
    for good in (1, 2, 4, 8, None):
        j, t = jmesh.get_mesh(good), tmesh.get_mesh(good)
        np.testing.assert_array_equal(_port_ids(t), _jax_ids(j))
        assert t.axis_names == tuple(j.axis_names) == ("rows",)


@pytest.mark.parametrize("topology", [None, {}, {"dcn": 2, "rows": 4}, {"dcn": 0}, {"rows": 2}, {"dcn": 4},
                                      {"dcn": 8, "rows": 1}])
def test_build_mesh_flat_and_2d_equal_jax(topology):
    j, t = jmesh.build_mesh(topology), tmesh.build_mesh(topology)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == tuple(j.devices.shape)
    np.testing.assert_array_equal(_port_ids(t), _jax_ids(j))


@pytest.mark.parametrize("topology", [{"dcn": 3, "rows": 4}, {"ici": 8}, {"dcn": 3}, {"rows": 3}])
def test_build_mesh_rejects_bad_topologies_as_jax(topology):
    with pytest.raises(JaxMeshTopologyError) as je:
        jmesh.build_mesh(topology)
    with pytest.raises(MeshTopologyError) as te:
        tmesh.build_mesh(topology)
    assert (te.value.available, te.value.topology) == (je.value.available, je.value.topology)


def test_build_mesh_reads_the_config_topology_knob():
    """The JAX package's build_mesh reads its `mesh_topology` knob; the
    port's takes the same topology as its argument (it has no knob: its
    fan-out runs flat ranks whatever the grid) and builds the same mesh."""
    assert "mesh_topology" not in tcore.config
    saved = jcore.config["mesh_topology"]
    try:
        jcore.config["mesh_topology"] = {"dcn": 2, "rows": 4}
        j, t = jmesh.build_mesh(), tmesh.build_mesh({"dcn": 2, "rows": 4})
        assert t.axis_names == tuple(j.axis_names) == ("dcn", "rows")
        np.testing.assert_array_equal(_port_ids(t), _jax_ids(j))
        # an explicit empty topology wins over the knob; the port's default is flat
        assert tmesh.build_mesh({}).axis_names == tuple(jmesh.build_mesh({}).axis_names) == ("rows",)
        assert tmesh.build_mesh().axis_names == ("rows",)
    finally:
        jcore.config["mesh_topology"] = saved


@pytest.mark.parametrize("chips", [4, 1, 8, [4, 5, 6, 7], [2, 3, 4], [7], [0, 2], [6, 7, 8], 9, [], [3, 3]])
def test_submesh_carves_contiguous_runs_as_jax(chips):
    jm, tm = jmesh.get_mesh(8), tmesh.get_mesh(8)
    try:
        j = jmesh.submesh(jm, chips)
    except JaxMeshTopologyError as e:
        with pytest.raises(MeshTopologyError) as te:
            tmesh.submesh(tm, chips)
        assert (te.value.requested, te.value.available) == (e.requested, e.available)
        return
    t = tmesh.submesh(tm, chips)
    assert t.axis_names == tuple(j.axis_names)
    np.testing.assert_array_equal(_port_ids(t), _jax_ids(j))


def test_submesh_by_device_objects_and_of_a_2d_mesh():
    tm = tmesh.get_mesh(8)
    jm = jmesh.get_mesh(8)
    t = tmesh.submesh(tm, list(tm.devices[2:5]))
    j = jmesh.submesh(jm, list(jm.devices.flatten()[2:5]))
    np.testing.assert_array_equal(_port_ids(t), _jax_ids(j))
    with pytest.raises(MeshTopologyError):
        tmesh.submesh(tm, [parallel.host_tensor(np.zeros(1)).device])  # not a chip of the mesh
    t2, j2 = tmesh.build_mesh({"dcn": 2, "rows": 4}), jmesh.build_mesh({"dcn": 2, "rows": 4})
    np.testing.assert_array_equal(_port_ids(tmesh.submesh(t2, 4)), _jax_ids(jmesh.submesh(j2, 4)))


def test_survivor_mesh_as_jax_on_one_process():
    for m_t, m_j in ((tmesh.get_mesh(8), jmesh.get_mesh(8)),
                     (tmesh.build_mesh({"dcn": 2, "rows": 4}), jmesh.build_mesh({"dcn": 2, "rows": 4})),
                     (tmesh.submesh(tmesh.get_mesh(8), 4), jmesh.submesh(jmesh.get_mesh(8), 4))):
        # every chip is process 0's: excluding another process keeps the mesh
        kept_t, kept_j = tmesh.survivor_mesh(m_t, {7}), jmesh.survivor_mesh(m_j, {7})
        assert kept_t.axis_names == tuple(kept_j.axis_names)
        np.testing.assert_array_equal(_port_ids(kept_t), _jax_ids(kept_j))
        with pytest.raises(JaxMeshTopologyError):
            jmesh.survivor_mesh(m_j, {0})
        with pytest.raises(MeshTopologyError):
            tmesh.survivor_mesh(m_t, {0})


def test_chip_scope_pins_default_devices_context_locally():
    pool = tmesh.default_devices()
    seen = {}

    def worker():
        # a sibling thread does not see the main thread's pin
        seen["other"] = (list(tmesh.default_devices()), tmesh.current_chip_ids())

    with tmesh.chip_scope(pool[4:]):
        assert tmesh.current_chip_scope() == tuple(pool[4:])
        assert tmesh.default_devices() == pool[4:]
        assert tmesh.current_chip_ids() == (4, 5, 6, 7)  # the pool's positions, kept
        assert tmesh.get_mesh().size == 4  # downstream mesh calls follow
        assert tuple(tmesh.get_mesh().chip_ids) == (4, 5, 6, 7)
        assert parallel.visible_device_count() == 4
        with tmesh.chip_scope(tmesh.default_devices()[2:]):
            assert tmesh.current_chip_ids() == (6, 7)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert seen["other"] == (pool, tuple(range(8)))
    assert tmesh.current_chip_scope() is None
    assert tmesh.default_devices() == pool
    # the JAX package's pin behaves the same way
    jpool = jmesh.default_devices()
    with jmesh.chip_scope(jpool[4:]):
        assert [int(d.id) for d in jmesh.default_devices()] == [4, 5, 6, 7]
        assert jmesh.get_mesh().devices.size == 4


def test_chip_scope_is_local_to_each_thread_at_once():
    pool = tmesh.default_devices()
    barrier = threading.Barrier(2)
    seen = {}

    def pinned(i):
        with tmesh.chip_scope(pool[4 * i:4 * i + 4]):
            barrier.wait(10)  # both pins live at once
            seen[i] = tmesh.current_chip_ids()
            barrier.wait(10)

    threads = [threading.Thread(target=pinned, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == {0: (0, 1, 2, 3), 1: (4, 5, 6, 7)}


def test_set_devices_pools_and_the_default_device():
    parallel.set_devices("cpu")
    assert len(tmesh.default_devices()) == 1 and parallel.visible_device_count() == 1
    parallel.set_devices(["cpu", "cpu"])
    assert parallel.default_device().type == "cpu" and parallel.visible_device_count() == 2
    with pytest.raises(MeshTopologyError):
        parallel.set_devices([])


@pytest.mark.parametrize("n,n_dev", [(600, 8), (601, 8), (7, 8), (0, 4), (10, 4), (9, 4), (1000, 3), (5, 1)])
def test_shard_row_slices_ranges_equal_jax(n, n_dev):
    x = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    jpieces, jpad = jmesh.shard_row_slices(x, n_dev)
    tpieces, tpad = tmesh.shard_row_slices(x, n_dev)
    assert tpad == jpad and len(tpieces) == len(jpieces) == n_dev
    for (lo, hi), jp, tp in zip(tmesh.shard_row_ranges(n, n_dev), jpieces, tpieces):
        # the port's block is the JAX block's valid rows, a view of x
        np.testing.assert_array_equal(tp, jp[: hi - lo])
        assert not np.any(jp[hi - lo:])  # JAX's padding rows are zero
        if tp.size:
            assert np.shares_memory(tp, x)
    assert sum(p.shape[0] for p in tpieces) == n
