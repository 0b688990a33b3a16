"""The JAX package behind the scenario runners' interface
(tests/test_torch_scenario_cases.py), and the bitwise comparison of a
JAX record with the port's.  No tests here."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

import test_torch_scenario_cases as sc

# record keys compared as plain values (the frames and state as arrays)
VALUES = ("origins", "leftover", "capacity", "warnings", "raised", "mirror",
          "gt", "csv")


def jax_api():
    import jax.numpy as jnp

    from gie_mapping_tpu import map_state as ms
    from gie_mapping_tpu.models import mapper as mm
    from gie_mapping_tpu.models import pipeline as pp
    from gie_mapping_tpu.utils import config, geometry as geo

    def fence(cfg):
        m = cfg.max_ext_obs
        return (jnp.zeros((m, 3), jnp.float32), jnp.zeros((m, 3), jnp.float32),
                jnp.zeros((m,), jnp.bool_), jnp.int32(0))

    def merge(cfg, state, inst, pvt, do_scroll=True):
        pvt = np.asarray(pvt, np.int32)
        origin_blk, _, off = ms.canvas_geometry(cfg, pvt)
        state, out = pp.merge_frame(
            state, jnp.asarray(inst, jnp.int8),
            jnp.zeros(cfg.local_size, jnp.int32), jnp.asarray(pvt),
            jnp.asarray(origin_blk), jnp.asarray(off), *fence(cfg), cfg=cfg,
            input_pointcloud=False, do_scroll=do_scroll)
        return state, {k: np.asarray(v) for k, v in out.items()}

    def scroll(cfg, state, origin_blk):
        return pp.scroll_step(state, jnp.asarray(origin_blk), cfg=cfg)

    return SimpleNamespace(
        config=config, Mapper=mm.VolumetricMapper,
        proj=lambda rot, trans: geo.Projection(np.asarray(rot, np.float32),
                                               np.asarray(trans, np.float32)),
        from_pose=geo.Projection.from_pose, create=ms.MapState.create,
        state=lambda s: {k: np.asarray(getattr(s, k)) for k in sc.FIELDS},
        merge=merge, scroll=scroll, canvas_geometry=ms.canvas_geometry,
        zeros_blocks=lambda cb: jnp.zeros(tuple(cb), jnp.bool_))


def assert_same(want: dict, got: dict, tag: str):
    """The port's record `got` equals the JAX package's `want` bit for bit:
    every frame's arrays and scalars (dtype too), the final state's every
    field (and every step's, where the record keeps them), origins,
    streaming leftovers, capacity report, warning texts, a raised error's
    text, the mirror's digest, the RMS checks' results, the CSV rows
    without their times, and what an on_frame hook returned."""
    assert len(got["frames"]) == len(want["frames"]), tag
    for i, (w, g) in enumerate(zip(want["frames"], got["frames"])):
        assert sorted(g) == sorted(w), (tag, i)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype, (tag, i, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} frame {i} {k}")
    states = list(zip(want.get("states", []), got.get("states", [])))
    assert len(got.get("states", [])) == len(states), tag
    for i, (ws, gs) in enumerate(states + [(want["state"], got["state"])]):
        for k in sc.FIELDS:
            a, b = np.asarray(gs[k]), np.asarray(ws[k])
            if k == "a_packed":
                a, b = a.view(np.uint32), b.view(np.uint32)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} state {i}.{k}")
    for k in VALUES:
        if k in want or k in got:
            assert got.get(k) == want.get(k), (tag, k, got.get(k), want.get(k))
    for i, (w, g) in enumerate(zip(want.get("extra", []), got.get("extra", []))):
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} extra {i}")


def both(runner, **kw):
    """Run a scenario on the JAX package and on the port (CPU), assert the
    records equal; returns (port cfg, port mapper or state, port record,
    JAX mapper or state)."""
    _, jm, want = runner(jax_api(), **kw)
    cfg, tm, got = runner(sc.port_api("cpu"), **kw)
    assert_same(want, got, f"{runner.__name__} {kw}")
    return cfg, tm, got, jm
