"""PyTorch port: host geometry (Mesh, group patterns, topology, OBJ/.geo
I/O, the fastgeo native library) against the JAX package on the same
inputs."""

import dataclasses

import numpy as np
import pytest
from scipy.spatial import cKDTree

import facedeform_tpu.geometry as jgeom
from facedeform_tpu.geometry import grouppattern as jgp
from facedeform_tpu.geometry import primitives as jprim
from facedeform_tpu.geometry import topology as jtopo
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu_torch import convert, native
from facedeform_tpu_torch import geometry as tgeom
from facedeform_tpu_torch.geometry import grouppattern as tgp
from facedeform_tpu_torch.geometry import primitives as tprim
from facedeform_tpu_torch.geometry import topology as ttopo
from facedeform_tpu_torch.geometry.mesh import Mesh as TMesh


def _pair(n=20):
    """The same 20-point mesh with groups and attributes in both packages
    (the fixtures of tests/test_grouppattern.py)."""
    out = []
    for cls in (JMesh, TMesh):
        m = cls(points=jprim.fibonacci_points(n))
        m.set_group("head", np.arange(5))
        m.set_group("hand_l", np.arange(5, 10))
        m.set_group("hand_r", np.arange(10, 15))
        m.set_attr("class", np.repeat(np.arange(4), 5).astype(np.int32))
        m.set_attr("id", np.arange(20, dtype=np.int64))
        m.set_attr("name", np.array([f"pt_{i % 3}" for i in range(20)]))
        m.set_attr("bigid", np.arange(20, dtype=np.int64) + 1_000_000)
        fv = np.zeros(20, np.float32)
        fv[7], fv[3], fv[4] = np.float32(123.456), np.float32(2e-6), np.float32(4e-6)
        m.set_attr("fv", fv)
        out.append(m)
    return out


# every pattern of tests/test_grouppattern.py
PATTERNS = [
    "head", "head hand_r", "hand_*", "hand_?", "*", "7", "3-6", "6-3", "18-99",
    "0-9:2", "0-9:2,5", "* ^hand_l", "* ^hand_l 7", "!head", "@class=1",
    "@class==1", "@class=0,3", "@class!=0", "@id<4", "@id<=4", "@id>17",
    "@id>=17", "@name=pt_0", "@name=pt_*", "@name=pt_0,pt_1", "@P.y>0",
    "@P.1>0", "@bigid=1000005", "@bigid!=1000005", "@fv=123.456",
    "@fv=0.000004", "@class=0,1 ^hand_l", "!@class=0",
]
BAD_PATTERNS = ["feet", "   ", "@missing=1", "@class=", "@name<3", "@P>0", "@P.w>0"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_group_pattern_matches_jax(pattern):
    jm, tm = _pair()
    want = jgp.parse_group_pattern(pattern, jm)
    got = tgp.parse_group_pattern(pattern, tm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.select_points(pattern), want)


@pytest.mark.parametrize("pattern", BAD_PATTERNS)
def test_group_pattern_errors_match_jax(pattern):
    jm, tm = _pair()
    with pytest.raises(Exception) as jerr:
        jm.select_points(pattern)
    with pytest.raises(type(jerr.value)) as terr:
        tm.select_points(pattern)
    assert str(terr.value) == str(jerr.value)


def test_mesh_data_ids_copy_and_subset():
    _, m = _pair()
    ids = (m.pos_id, m.top_id, m.attr_id)
    m.set_points(m.points + 1.0)
    assert m.pos_id > ids[0] and m.top_id == ids[1] and m.attr_id == ids[2]
    m.set_faces(np.int32([[0, 1, 2]]))
    assert m.top_id > ids[1]
    a = m.attr_id
    m.set_attr("w", np.ones(20, np.float32))
    assert m.attr_id > a
    m.set_group("tail", np.arange(15, 20))
    assert m.attr_id > a
    with pytest.raises(ValueError, match="cannot change point count"):
        m.set_points(np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        m.set_group("bad", np.array([20]))
    c = m.copy()
    assert c.pos_id not in (m.pos_id, m.top_id, m.attr_id)
    c.points[0] += 5.0
    assert not np.array_equal(c.points[0], m.points[0])
    s = m.subset(np.array([1, 7, 12]))
    assert s.faces is None and s.num_points == 3
    np.testing.assert_array_equal(s.point_attrs["class"], [0, 1, 2])
    np.testing.assert_array_equal(s.group_mask("hand_l"), [False, True, False])


@pytest.mark.parametrize("shape", ["sphere", "grid", "mixed"])
def test_triangles_and_reorder_match_jax(shape):
    if shape == "sphere":
        jm, tm = jprim.uv_sphere(9, 7), tprim.uv_sphere(9, 7)
    elif shape == "grid":
        jm, tm = jprim.grid(6, 5), tprim.grid(6, 5)
    else:
        pts = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [2, 0, 0]])
        faces = np.int32([[0, 1, 2, 3], [1, 4, 2, -1]])
        jm, tm = JMesh(points=pts, faces=faces), TMesh(points=pts, faces=faces)
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.triangles(), jm.triangles())
    jm.set_attr("id", np.arange(jm.num_points))
    tm.set_attr("id", np.arange(tm.num_points))
    jr, tr = jm.reorder_spatial(), tm.reorder_spatial()
    np.testing.assert_array_equal(tr.points, jr.points)
    np.testing.assert_array_equal(tr.faces, jr.faces)
    np.testing.assert_array_equal(tr.point_attrs["id"], jr.point_attrs["id"])


@pytest.mark.parametrize("shape", ["sphere", "grid", "fanned"])
@pytest.mark.parametrize("native_lib", [True, False])
def test_mesh_adjacency_matches_jax(shape, native_lib, monkeypatch):
    """The CSR adjacency equals the JAX package's (which takes its own
    native library when it loads), on the port's native and numpy paths."""
    if native_lib and not native.available():
        pytest.skip("g++ toolchain unavailable")
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    if shape == "sphere":
        jm, tm = jprim.uv_sphere(15, 12), tprim.uv_sphere(15, 12)
    elif shape == "grid":
        jm, tm = jprim.grid(9, 8), tprim.grid(9, 8)
    else:
        faces = np.int32([[0, 1, 2, 2], [1, 2, 3, 3], [2, 3, 4, 5]])
        pts = np.arange(18, dtype=np.float32).reshape(6, 3)
        jm, tm = JMesh(points=pts, faces=faces), TMesh(points=pts, faces=faces)
    j_indptr, j_indices = jtopo.mesh_adjacency(jm)
    t_indptr, t_indices = ttopo.mesh_adjacency(tm)
    np.testing.assert_array_equal(t_indptr, j_indptr)
    for v in range(tm.num_points):
        a = np.sort(t_indices[t_indptr[v]:t_indptr[v + 1]])
        b = np.sort(j_indices[j_indptr[v]:j_indptr[v + 1]])
        np.testing.assert_array_equal(a, b)
        assert v not in a   # fanned padding makes no self-edges


def test_topology_helpers_match_jax():
    jm, tm = jprim.uv_sphere(12, 10), tprim.uv_sphere(12, 10)
    np.testing.assert_array_equal(ttopo.unique_edges(tm.faces), jtopo.unique_edges(jm.faces))
    e = jtopo.unique_edges(jm.faces)
    for cap in (None, 4):
        for t, j in zip(ttopo.padded_neighbors(tm.num_points, e, cap),
                        jtopo.padded_neighbors(jm.num_points, e, cap)):
            np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(ttopo.vertex_normals(tm), jtopo.vertex_normals(jm))
    jtopo.compute_tangent_frame(jm)
    ttopo.compute_tangent_frame(tm)
    for name in ("N", "tangentu", "tangentv"):
        np.testing.assert_array_equal(tm.point_attrs[name], jm.point_attrs[name])


def _decorated(cls, prim):
    m = prim.uv_sphere(10, 8)
    m = cls(points=m.points, faces=m.faces)
    rng = np.random.default_rng(3)
    m.set_attr("N", rng.standard_normal((m.num_points, 3)).astype(np.float32))
    m.set_attr("class", np.arange(m.num_points, dtype=np.int32) % 3)
    m.set_attr("fd_falloff", rng.random(m.num_points).astype(np.float32))
    m.set_group("lips", m.points[:, 1] > 0.2)
    m.detail_attrs["weights"] = np.asarray([0.25, -1.5, 3.0], np.float32)
    return m


@pytest.mark.parametrize("ext", [".obj", ".geo"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_load_bit_equal_across_packages(ext, writer, tmp_path):
    """A file written by either package loads into equal meshes in both:
    points, faces, attributes, groups and detail attributes bit for bit."""
    jm = _decorated(JMesh, jprim)
    tm = _decorated(TMesh, tprim)
    path = str(tmp_path / f"m{ext}")
    (jgeom.save_mesh if writer == "jax" else tgeom.save_mesh)(path, jm if writer == "jax" else tm)
    jl, tl = jgeom.load_mesh(path), tgeom.load_mesh(path)
    np.testing.assert_array_equal(tl.points, jl.points)
    np.testing.assert_array_equal(tl.faces, jl.faces)
    np.testing.assert_array_equal(tl.points, tm.points)
    assert sorted(tl.point_attrs) == sorted(jl.point_attrs)
    for k in jl.point_attrs:
        np.testing.assert_array_equal(tl.point_attrs[k], jl.point_attrs[k])
    assert sorted(tl.point_groups) == sorted(jl.point_groups)
    for k in jl.point_groups:
        np.testing.assert_array_equal(tl.point_groups[k], jl.point_groups[k])
    for k in jl.detail_attrs:
        np.testing.assert_array_equal(tl.detail_attrs[k], jl.detail_attrs[k])
    assert tl.attr_typeinfo == jl.attr_typeinfo


def test_obj_tabs_relative_indices_and_glb(tmp_path):
    """The OBJ reader's tab and relative-index handling equals the JAX
    package's; load_mesh/save_mesh dispatch .glb to the glTF module, whose
    file equals the JAX package's byte for byte."""
    path = tmp_path / "t.obj"
    path.write_text("v\t0 0 0\nv 1 0 0\nv\t1 1 0\nv 0 1 0\ng top\nf\t-4 -3 -2\nf 1 3 4\n")
    jl, tl = jgeom.load_mesh(str(path)), tgeom.load_mesh(str(path))
    np.testing.assert_array_equal(tl.points, jl.points)
    np.testing.assert_array_equal(tl.faces, jl.faces)
    np.testing.assert_array_equal(tl.group_mask("top"), jl.group_mask("top"))
    tgeom.save_mesh(str(tmp_path / "t.glb"), tl)
    jgeom.save_mesh(str(tmp_path / "j.glb"), jl)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    back = tgeom.load_mesh(str(tmp_path / "j.glb"))
    np.testing.assert_array_equal(back.points, jl.points)
    np.testing.assert_array_equal(back.triangles(), jl.triangles())


def test_mesh_from_fields_carries_everything():
    jm = _decorated(JMesh, jprim)
    jm.attr_typeinfo["N"] = "normal"
    tm = convert.mesh_from_fields(dataclasses.asdict(jm))
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    for k in jm.point_attrs:
        np.testing.assert_array_equal(tm.point_attrs[k], jm.point_attrs[k])
    np.testing.assert_array_equal(tm.group_mask("lips"), jm.group_mask("lips"))
    np.testing.assert_array_equal(tm.detail_attrs["weights"], jm.detail_attrs["weights"])
    assert tm.attr_typeinfo == {"N": "normal"}
    tm.points[0] += 1.0
    assert not np.array_equal(tm.points[0], jm.points[0])


def _python_bfs(indptr, indices, seeds, rings, n):
    visited = np.zeros(n, bool)
    visited[seeds] = True
    frontier = set(seeds.tolist())
    for _ in range(rings):
        nxt = set()
        for v in frontier:
            for u in indices[indptr[v]:indptr[v + 1]]:
                if not visited[u]:
                    visited[u] = True
                    nxt.add(int(u))
        frontier = nxt
    return visited


def test_native_matches_fallbacks(monkeypatch, tmp_path):
    """Each fastgeo entry point against the numpy/scipy path that replaces
    it when the library does not load: BFS rings, nearest point,
    Dijkstra, adjacency and the OBJ parser."""
    if not native.available():
        pytest.skip("g++ toolchain unavailable")
    from facedeform_tpu_torch.capture import flood, geodesic
    from facedeform_tpu_torch.geometry import obj_io

    rng = np.random.default_rng(7)
    mesh = tprim.uv_sphere(30, 30)
    n = mesh.num_points
    indptr, indices = ttopo.adjacency_csr(n, ttopo.unique_edges(mesh.faces))
    seeds = rng.integers(0, n, size=5).astype(np.int64)
    got_bfs = native.bfs_rings(indptr, indices, seeds, 3)
    np.testing.assert_array_equal(got_bfs, _python_bfs(indptr, indices, seeds, 3, n))
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    queries = rng.standard_normal((100, 3)).astype(np.float32)
    got_nn = native.nearest(pts, queries)
    _, want_nn = cKDTree(pts).query(queries)
    np.testing.assert_allclose(np.linalg.norm(pts[got_nn] - queries, axis=1),
                               np.linalg.norm(pts[want_nn] - queries, axis=1), atol=1e-6)
    offsets = rng.random(5).astype(np.float32) * 0.01
    got_geo = geodesic.geodesic_distance(indptr, indices, mesh.points, seeds, offsets)
    obj = str(tmp_path / "s.obj")
    tgeom.save_mesh(obj, mesh)
    got_obj = obj_io.load_obj(obj)

    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(
        flood.multi_source_edge_rings(indptr, indices, seeds, 3), got_bfs)
    want_geo = geodesic.geodesic_distance(indptr, indices, mesh.points, seeds, offsets)
    np.testing.assert_allclose(got_geo, want_geo, rtol=1e-5)
    w_indptr, w_indices = ttopo.mesh_adjacency(mesh)
    np.testing.assert_array_equal(w_indptr, indptr)
    want_obj = obj_io.load_obj(obj)
    np.testing.assert_array_equal(got_obj.points, want_obj.points)
    np.testing.assert_array_equal(got_obj.faces, want_obj.faces)


def test_native_build_is_atomic_and_keyed_by_source(monkeypatch, tmp_path):
    """The library is named by its source's hash, and a build goes through
    a temporary file renamed into place: it loads and leaves no temporary
    file behind."""
    if not native.available():
        pytest.skip("g++ toolchain unavailable")
    import os

    assert os.path.basename(native.library_path()).startswith("libfastgeo_")
    assert os.path.exists(native.library_path())
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    target = str(tmp_path / os.path.basename(native.library_path()))
    assert native._build(target)
    assert os.listdir(tmp_path) == [os.path.basename(target)]
    assert native._load_and_bind(target) is not None
