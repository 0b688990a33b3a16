"""The port's native host library (gie_mapping_tpu_torch/runtime/native.py,
native/src/gie_host.cpp) against the JAX package's: the source, the build,
and each entry point on seeded inputs, bit for bit."""
import ctypes
import os

import numpy as np
import pytest

from gie_mapping_tpu.runtime import clustering as jclust
from gie_mapping_tpu.runtime import gt_checker as jgt
from gie_mapping_tpu.runtime import native as jnative
from gie_mapping_tpu.runtime import rings as jrings
from gie_mapping_tpu_torch.runtime import clustering as tclust
from gie_mapping_tpu_torch.runtime import gt_checker as tgt
from gie_mapping_tpu_torch.runtime import native as tnative
from gie_mapping_tpu_torch.runtime import rings as trings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jlib():
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native library must load"
    return lib


def test_source_is_the_jax_packages():
    """The port compiles the JAX package's C++ source; only the comments'
    paths to the reference checkout are dropped."""
    with open(os.path.join(ROOT, "gie_mapping_tpu", "native", "src",
                           "gie_host.cpp")) as f:
        jsrc = f.read()
    tsrc = tnative.SOURCE.read_text()
    assert tsrc == jsrc.replace("/" + "root/reference/", "")
    assert tnative.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC",
                                 "-std=c++17")


def test_library_builds_into_the_ignored_directory():
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR and so.exists()
    assert so.name == tnative.library_path().name
    rel = os.path.relpath(tnative.BUILD_DIR, ROOT).replace(os.sep, "/") + "/"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert rel in f.read().split(), f"{rel} is not in .gitignore"
    lib = tnative.get_lib()
    for name in tnative.SIGNATURES:
        assert hasattr(lib, name)
    assert len(tnative.SIGNATURES) == 9


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cpp"):
        tnative.build()
    assert not any((tmp_path / "build").iterdir())  # no half-written library


def _border_cloud(rng, scan_num, ring_num):
    """Points at bin centres, on the borders between bins (theta_min +
    (k + 0.5) theta_inc, rounded to float32), a hair either side of them,
    on the +-pi seam, at zero range, plus ring ids out of range."""
    inc = 2 * np.pi / scan_num
    k = np.arange(scan_num)
    th = np.concatenate([-np.pi + k * inc, -np.pi + (k + 0.5) * inc,
                         np.nextafter(np.float32(-np.pi + (k + 0.5) * inc),
                                      np.float32(9)),
                         np.nextafter(np.float32(-np.pi + (k + 0.5) * inc),
                                      np.float32(-9)),
                         [np.pi, -np.pi, np.float32(np.pi)]])
    r = rng.uniform(0.5, 30.0, len(th))
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(-2, 2, len(th))], -1).astype(np.float32)
    pts = np.concatenate([pts, [[0.0, 0.0, 1.0], [0.0, -0.0, 0.0]]]).astype(np.float32)
    rings = rng.integers(-2, ring_num + 3, len(pts)).astype(np.int32)
    return pts, rings


@pytest.mark.parametrize("ring_num,scan_num", [(16, 360), (4, 1800), (32, 7)])
def test_cloud_to_rings_matches_jax(ring_num, scan_num):
    rng = np.random.default_rng(ring_num * 1000 + scan_num)
    pts, rings = _border_cloud(rng, scan_num, ring_num)
    rand = rng.normal(0, 8, (5000, 3)).astype(np.float32)
    pts = np.concatenate([pts, rand])
    rings = np.concatenate([rings, rng.integers(-1, ring_num + 1, 5000)
                            .astype(np.int32)])
    ji, jt0, jti = jrings.cloud_to_rings(pts, rings, ring_num, scan_num)
    ti, tt0, tti = trings.cloud_to_rings(pts, rings, ring_num, scan_num)
    np.testing.assert_array_equal(ti.view(np.uint32), ji.view(np.uint32))
    assert (tt0, tti) == (jt0, jti)
    assert type(tt0) is type(jt0) and type(tti) is type(jti)
    assert np.isfinite(ti).any()
    if scan_num >= 360:
        assert np.isnan(ti).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_and_fence_boxes_match_jax(seed):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-6, 6, (7, 3))
    parts = [rng.normal(c, rng.uniform(0.03, 0.2), (rng.integers(2, 60), 3))
             for c in centres]
    parts.append(rng.uniform(-10, 10, (40, 3)))  # noise
    pts = np.concatenate(parts).astype(np.float32)
    rng.shuffle(pts)
    for kw in ({}, dict(eps=0.5, min_pts=2, min_cluster=3, max_boxes=4)):
        jb = jclust.dbscan_aabb(pts, **kw)
        tb = tclust.dbscan_aabb(pts, **kw)
        assert tb.dtype == jb.dtype and tb.shape == jb.shape
        np.testing.assert_array_equal(tb, jb)
    assert len(tclust.dbscan_aabb(pts)) >= 3
    for is_3d in (False, True):
        jf = jclust.cloud_to_fence_boxes(pts, is_3d)
        tf = tclust.cloud_to_fence_boxes(pts, is_3d)
        assert len(tf) == len(jf)
        for (tll, tur), (jll, jur) in zip(tf, jf):
            np.testing.assert_array_equal(np.asarray(tll, np.float32),
                                          np.asarray(jll, np.float32))
            np.testing.assert_array_equal(np.asarray(tur, np.float32),
                                          np.asarray(jur, np.float32))
    assert tclust.dbscan_aabb(np.zeros((0, 3), np.float32)).shape == (0, 2, 3)


def test_knn_errors_match_jax_and_scipy():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(5)
    occ = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    q = rng.uniform(-6, 6, (8000, 3)).astype(np.float32)
    knn, _ = cKDTree(occ).query(q, k=1)
    edt = (knn + rng.normal(0, 0.02, len(q))).astype(np.float32)
    got = tgt.knn_errors(occ, q, edt)
    assert got == jgt.knn_errors(occ, q, edt)
    err = knn - edt.astype(np.float64)
    np.testing.assert_allclose(got, [np.sqrt((err ** 2).mean()),
                                     np.abs(err).max(), np.abs(err).mean()],
                               rtol=1e-5)
    assert tgt.knn_errors(occ[:0], q, edt) == (-1.0, -1.0, -1.0)


def test_mirror_store_matches_jax(jlib):
    tlib = tnative.get_lib()
    rng = np.random.default_rng(11)
    n = 40
    keys = np.unique(rng.integers(-5, 5, (n, 3)), axis=0).astype(np.int32)
    n = len(keys)
    occ = rng.integers(0, 256, (n, 512)).astype(np.uint8)
    typ = rng.integers(-1, 3, (n, 512)).astype(np.int8)
    dist = np.where(rng.random((n, 512)) < 0.3, 999999,
                    rng.integers(0, 400, (n, 512))).astype(np.int32)
    coc = rng.integers(-300, 300, (n, 512, 3)).astype(np.int16)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    outs = []
    for lib in (jlib, tlib):
        h = lib.gie_mirror_new()
        try:
            lib.gie_mirror_ingest(h, p(keys, ctypes.c_int32),
                                  p(occ, ctypes.c_uint8), p(typ, ctypes.c_int8),
                                  p(dist, ctypes.c_int32),
                                  p(coc, ctypes.c_int16), n)
            # a re-ingest of a block overwrites it
            lib.gie_mirror_ingest(h, p(keys[:3], ctypes.c_int32),
                                  p(occ[3:6].copy(), ctypes.c_uint8),
                                  p(typ[3:6].copy(), ctypes.c_int8),
                                  p(dist[3:6].copy(), ctypes.c_int32),
                                  p(coc[3:6].copy(), ctypes.c_int16), 3)
            size = lib.gie_mirror_size(h)
            cloud = np.zeros((n * 512, 3), np.float32)
            k1 = lib.gie_mirror_extract_cloud(h, 2, 0.1, p(cloud, ctypes.c_float),
                                              n * 512)
            capped = np.zeros((100, 3), np.float32)
            k2 = lib.gie_mirror_extract_cloud(h, 1, 0.2,
                                              p(capped, ctypes.c_float), 100)
            pos = np.zeros((n * 512, 3), np.float32)
            d = np.zeros(n * 512, np.float32)
            k3 = lib.gie_mirror_extract_edt(h, 999999, 0.1,
                                            p(pos, ctypes.c_float),
                                            p(d, ctypes.c_float), n * 512)
        finally:
            lib.gie_mirror_free(h)
        outs.append((size, k1, cloud[:k1], k2, capped, k3, pos[:k3], d[:k3]))
    (js, *jrest), (ts, *trest) = outs
    assert ts == js == n
    for a, b in zip(trest, jrest):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert outs[1][1] > 0 and outs[1][3] == 100 and outs[1][5] > 0
