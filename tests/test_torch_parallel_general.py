"""The port's distributed imported-mesh path
(``wave_fenics_tpu_torch.parallel.sharded_general``) against the JAX
package's, on the CPU in float64: the RCB partition and every set-up table
exactly (sentinels aside), the per-part RK4, leapfrog and CG states at
1e-12 relative, both assembly modes, dofs held by three or more parts, and
the one-device model at 1e-13. Then the slice's entry points on the CPU:
the XDMF workflow over 4 parts, the app's ``--mesh ... --ndev``,
``cg_bench --op general --ndev`` and ``scatter_bench``'s three modes.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices under
``jit``, with ``use_fused=False``: the indexed local apply, the plain
reference of its Pallas kernel. Models are ``tests/test_sharded_general.py``'s
``_perturbed_model`` (6x4x4 cells, interior vertices jittered), built in
both packages from the same points, cells and facets.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel
from jax import shard_map

from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.general_wave import GeneralLinearWave as JGeneralLinearWave
from wave_fenics_tpu.parallel.sharded_general import ShardedGeneralWave as JSharded
from wave_fenics_tpu.parallel.sharded_general import rcb_partition as jrcb_partition
from wave_fenics_tpu.solvers.cg import cg as jcg
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks import cg_bench, common, scatter_bench
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.core import io
from wave_fenics_tpu_torch.core.mesh import HEX_FACES, HexMesh
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave, from_xdmf
from wave_fenics_tpu_torch.parallel import halo, partition
from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave, rcb_partition
from wave_fenics_tpu_torch.solvers.cg import cg

F64 = torch.float64
TOL = 1e-12
DT = 1e-9
EXT = np.array([0.012, 0.008, 0.008])


def _xface_quads(hm, x0):
    """The x = x0 faces of a hex mesh, in the JAX test's vertex order."""
    on = np.abs(hm.points[:, 0] - x0) < 1e-12
    faces = hm.cells[:, HEX_FACES].reshape(-1, 4)
    return faces[on[faces].all(axis=1)]


def _pair(p=4, cells=(6, 4, 4), seed=0):
    """(JAX model, port model) of ``_perturbed_model(p, cells, seed)``."""
    rng = np.random.default_rng(seed)
    hm = jbox_mesh(tuple(cells), tuple(EXT)).to_hex_mesh()
    pts = hm.points.copy()
    inner = np.all((pts > 1e-12) & (pts < EXT - 1e-12), axis=1)
    pts[inner] += 0.0004 * rng.standard_normal(pts[inner].shape)
    tags = {1: _xface_quads(hm, 0.0), 2: _xface_quads(hm, EXT[0])}
    jm = JGeneralLinearWave(mesh=JHexMesh(points=pts, cells=hm.cells), p=p,
                            facet_tags=tags, dtype=jnp.float64)
    tm = GeneralLinearWave(HexMesh(points=pts, cells=hm.cells), p, tags, dtype=F64,
                           device="cpu")
    return jm, tm


def _parts_rel(jx, tx, sw) -> float:
    """max over parts |port - JAX| / max |JAX|, element for element."""
    jx = np.asarray(jx)
    ids = sw._setup["loc_ids"]
    err = max(float(np.abs(jx[i, : len(ids[i])] - tx[i].numpy()).max())
              for i in range(sw.ndev))
    return err / max(float(np.abs(jx).max()), 1e-300)


# (ndev, p, exchange) of the JAX package's tests
CASES = [(8, 4, "allgather"), (8, 4, "ppermute"), (4, 2, "auto"), (3, 3, "ppermute")]


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_rcb_partition_matches_jax(n):
    """Random points, and points with ties along every axis (integer grid
    points, repeated): the part ids equal the JAX package's."""
    rng = np.random.default_rng(n)
    for pts in (rng.standard_normal((1000, 3)),
                np.repeat(rng.integers(0, 4, (333, 3)).astype(float), 3, axis=0)):
        part = rcb_partition(pts, n)
        np.testing.assert_array_equal(part, jrcb_partition(pts, n))
        counts = np.bincount(part, minlength=n)
        assert counts.min() >= len(pts) // n and counts.max() <= -(-len(pts) // n)


@pytest.mark.parametrize("ndev,p,exchange", CASES + [(2, 2, "allgather"), (5, 2, "auto")])
def test_setup_tables_match_jax(ndev, p, exchange):
    """loc_ids, ldof, own, bidx, recv, the pairwise tables (sidx = ridx,
    perms, NR, Sb) and the resolved mode equal the JAX package's; where the
    JAX tables pad with a sentinel, the port's parts end."""
    jm, tm = _pair(p, seed=p)
    js = JSharded(jm, ndev, exchange=exchange, use_fused=False)
    ts = ShardedGeneralWave(tm, ndev, exchange=exchange, device="cpu")
    a, b = js._setup, ts._setup
    np.testing.assert_array_equal(b["part"], a["part"])
    assert (b["S"], b["K"]) == (a["S"], a["K"])
    own = ts._tables["own"]
    for i in range(ndev):
        nc, nl, si = len(b["cells_of"][i]), len(b["loc_ids"][i]), len(b["bidx"][i])
        np.testing.assert_array_equal(b["cells_of"][i], a["cells_of"][i])
        np.testing.assert_array_equal(b["loc_ids"][i], a["loc_ids"][i])
        np.testing.assert_array_equal(b["ldof"][i], a["ldof"][i, :nc])
        assert (a["ldof"][i, nc:] == a["NL"]).all()
        np.testing.assert_array_equal(own[i].numpy(), a["own"][i, :nl])
        np.testing.assert_array_equal(b["bidx"][i], a["bidx"][i, :si])
        assert (a["bidx"][i, si:] == a["NL"]).all()
        np.testing.assert_array_equal(b["recv"][i], a["recv"][i, :si])
        assert (a["recv"][i, si:] == ndev * a["S"]).all()
    na, nb = js._nbr_setup, ts._nbr_setup
    assert (nb["NR"], nb["Sb"], nb["perms"]) == (na["NR"], na["Sb"], na["perms"])
    for i in range(ndev):
        for r in range(na["NR"]):
            x = nb["sidx"][i][r]
            if x is None:
                assert (na["sidx"][i, r] == js._lv).all() and (na["ridx"][i, r] == a["NL"]).all()
            else:
                np.testing.assert_array_equal(x, na["sidx"][i, r, : len(x)])
                np.testing.assert_array_equal(x, na["ridx"][i, r, : len(x)])
                assert (na["sidx"][i, r, len(x):] == js._lv).all()
    assert ts.exchange_mode == js.exchange_mode


@pytest.mark.parametrize("ndev,p,exchange", CASES)
def test_rk4_matches_jax_and_one_device(ndev, p, exchange):
    """6 RK4 steps: each part's u and v against the JAX package's part for
    part at 1e-12, and ``to_global`` against the port's one-device solve at
    1e-13."""
    jm, tm = _pair(p, seed=p)
    js = JSharded(jm, ndev, exchange=exchange, use_fused=False)
    ts = ShardedGeneralWave(tm, ndev, exchange=exchange)
    assert ts.mesh.devices == (torch.device("cpu"),) * ndev
    ju, jv, _ = js.solve_n(0.0, DT, 6)
    tu, tv, n = ts.solve_n(0.0, DT, 6)
    assert n == 6
    assert _parts_rel(ju, tu, ts) <= TOL and _parts_rel(jv, tv, ts) <= TOL
    u1, v1 = tm.solve_n(0.0, DT, 6)
    assert max_rel(ts.to_global(tu), u1) <= 1e-13
    assert max_rel(ts.to_global(tv), v1) <= 1e-13
    assert float(v1.abs().max()) > 0


@pytest.mark.parametrize("ndev,exchange", [(8, "ppermute"), (4, "allgather")])
def test_leapfrog_matches_jax_and_one_device(ndev, exchange):
    jm, tm = _pair(3, seed=5)
    js = JSharded(jm, ndev, exchange=exchange, use_fused=False)
    ts = ShardedGeneralWave(tm, ndev, exchange=exchange)
    ju, jv, _ = js.solve_n(0.0, DT, 6, integrator="leapfrog")
    tu, tv, _ = ts.solve_n(0.0, DT, 6, integrator="leapfrog")
    assert _parts_rel(ju, tu, ts) <= TOL and _parts_rel(jv, tv, ts) <= TOL
    u1, v1 = tm.solve_n(0.0, DT, 6, integrator="leapfrog")
    assert max_rel(ts.to_global(tu), u1) <= 1e-13
    assert max_rel(ts.to_global(tv), v1) <= 1e-13


def test_dot_and_roundtrip():
    """The ownership-weighted dot against the global one (1e-12) and the
    JAX package's; from_global then to_global gives the vector back."""
    jm, tm = _pair(3, seed=2)
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(tm.ndofs), rng.standard_normal(tm.ndofs)
    ts = ShardedGeneralWave(tm, 8)
    js = JSharded(jm, 8, use_fused=False)
    d = float(ts.dot(ts.from_global(x), ts.from_global(torch.as_tensor(y))))
    assert d == pytest.approx(float(x @ y), rel=TOL)
    assert d == pytest.approx(float(js.dot(js.from_global(x), js.from_global(y))), rel=TOL)
    np.testing.assert_array_equal(ts.to_global(ts.from_global(x)), x)


@pytest.mark.parametrize("ndev,p,exchange", [(8, 4, "ppermute"), (4, 2, "allgather")])
def test_cg_matches_jax_and_one_device(ndev, p, exchange):
    """CG on (diag(m) + tau K) x = b: the iterations equal the JAX
    package's, x per part at 1e-12; against the same CG on one device, the
    JAX test's tolerance."""
    jm, tm = _pair(p, seed=10 + p)
    bg = np.random.default_rng(4).standard_normal(tm.ndofs)
    tau = (0.25 * (0.012 / 6) / (tm.c0 * p * p)) ** 2
    js = JSharded(jm, ndev, exchange=exchange, use_fused=False)
    ts = ShardedGeneralWave(tm, ndev, exchange=exchange)
    jx, jk, _ = js.cg_solve(js.from_global(bg), tau, kmax=80, rtol=1e-10)
    tx, tk, _ = ts.cg_solve(ts.from_global(bg), tau, kmax=80, rtol=1e-10)
    assert tk == jk and 0 < tk < 80
    assert _parts_rel(jx, tx, ts) <= TOL
    m = tm.m
    xg, _, _ = cg(lambda z: m * z - tau * tm.ops.stiffness_indexed(z, tm.c0),
                  torch.as_tensor(bg), kmax=80, rtol=1e-10, precond=lambda r: r / m)
    assert max_rel(ts.to_global(tx), xg) <= 1e-8
    jm1 = jnp.asarray(jm.m)
    jxg, _, _ = jcg(lambda z: jm1 * z - tau * jm.ops.stiffness_indexed(z, jm.c0),
                    jnp.asarray(bg), kmax=80, rtol=1e-10, precond=lambda r: r / jm1)
    assert max_rel(xg, np.asarray(jxg)) <= 1e-8


def test_exchange_modes_agree_and_repeat_bitwise():
    """allgather and ppermute give one solve (1e-13); a second solve in one
    mode gives the first bit for bit (no add meets another in one place)."""
    _, tm = _pair(2, seed=11)
    sa = ShardedGeneralWave(tm, 8, exchange="allgather")
    sp = ShardedGeneralWave(tm, 8, exchange="ppermute")
    va = sa.to_global(sa.solve_n(0.0, DT, 4)[1])
    vp = sp.to_global(sp.solve_n(0.0, DT, 4)[1])
    assert max_rel(vp, va) <= 1e-13
    np.testing.assert_array_equal(sp.to_global(sp.solve_n(0.0, DT, 4)[1]), vp)


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_dofs_of_three_or_more_parts_assemble_right(exchange):
    """The 8-part partition holds dofs in up to 8 parts. The assembled
    stiffness of a random vector equals the one-device stiffness at every
    copy of every dof (1e-13), those of three or more holders included; in
    the ppermute tables each part sends each dof once to each other holder.
    Packing a round's bucket from values that earlier rounds have changed
    would count a three-holder dof's partials twice."""
    _, tm = _pair(3, seed=7)
    sw = ShardedGeneralWave(tm, 8, exchange=exchange)
    counts = sw._setup["counts"]
    assert counts.max() >= 3 and (counts >= 3).sum() > 10
    x = np.random.default_rng(3).standard_normal(tm.ndofs)
    y1 = tm.ops.stiffness(torch.as_tensor(x), tm.c0).numpy()
    y = sw._stiffness(sw.from_global(x))
    scale = np.abs(y1).max()
    for i, ids in enumerate(sw._setup["loc_ids"]):
        assert np.abs(y[i].numpy() - y1[ids]).max() <= 1e-13 * scale
    ns = sw._nbr_setup
    for i, ids in enumerate(sw._setup["loc_ids"]):
        sent = np.concatenate([x for x in ns["sidx"][i] if x is not None])
        gs, n = np.unique(ids[sent], return_counts=True)
        np.testing.assert_array_equal(n, counts[gs] - 1)
    for perm in ns["perms"]:
        assert len({a for a, _ in perm}) == len(perm)


def test_unknown_exchange_and_integrator_raise():
    _, tm = _pair(2, cells=(2, 2, 2))
    with pytest.raises(ValueError, match="unknown exchange mode 'ring'"):
        ShardedGeneralWave(tm, 2, exchange="ring")
    with pytest.raises(ValueError, match="unknown integrator"):
        ShardedGeneralWave(tm, 2).solve_n(0.0, DT, 1, integrator="euler")
    with pytest.raises(ValueError, match="at least 1"):
        ShardedGeneralWave(tm, 0)


def test_one_part_is_the_one_device_model():
    """ndev = 1: no interface, no pairwise tables, the one-device solve."""
    _, tm = _pair(2, cells=(3, 2, 2))
    sw = ShardedGeneralWave(tm, 1)
    assert sw._nbr_setup is None and sw.exchange_mode == "allgather"
    u1, v1 = tm.solve_n(0.0, DT, 3)
    assert max_rel(sw.to_global(sw.solve_n(0.0, DT, 3)[1]), v1) <= 1e-13


def test_local_exchange_collectives():
    """all_gather concatenates in block order; swap_pairs hands each side
    the other's buffer."""
    ex = halo.LocalExchange(partition.make_device_mesh((3, 1, 1), device="cpu"))
    bufs = partition.Blocks(torch.full((2,), float(b)) for b in range(3))
    full = ex.all_gather(bufs)
    assert all(torch.equal(f, torch.tensor([0.0, 0, 1, 1, 2, 2])) for f in full)
    got = ex.swap_pairs([(0, 2)], {(0, 2): torch.ones(3), (2, 0): 2 * torch.ones(3)})
    assert set(got) == {(0, 2), (2, 0)}
    assert torch.equal(got[(0, 2)], 2 * torch.ones(3))
    assert torch.equal(got[(2, 0)], torch.ones(3))


def test_blocks_elementwise_arithmetic():
    """The leapfrog's Blocks arithmetic: Blocks with Blocks, numbers on
    either side, division."""
    x = partition.Blocks([torch.ones(2), None, 2 * torch.ones(3)])
    y = partition.Blocks([3 * torch.ones(2), None, 4 * torch.ones(3)])
    z = (1.0 - 0.5 * x) * y / (1.0 + x)
    assert z[1] is None and torch.equal(z[2], torch.zeros(3))
    assert torch.equal(z[0], 0.75 * torch.ones(2))


# -- the slice's entry points ------------------------------------------------

def test_imported_mesh_distributed_solve(tmp_path):
    """The XDMF workflow over 4 parts (``tests/test_imported_mesh.py``'s
    distributed case): mesh and x-face tags written and read back, the model
    built from them, 5 RK4 steps on 4 parts against one device (1e-13)."""
    hm, tags = perturbed_box((3, 2, 2), h=0.3, amp_rel=0.06)
    mp, tp = str(tmp_path / "m.xdmf"), str(tmp_path / "t.xdmf")
    io.write_xdmf_mesh(mp, hm)
    io.write_xdmf_meshtags(tp, hm, np.concatenate([tags[1], tags[2]]),
                           [1] * len(tags[1]) + [2] * len(tags[2]))
    md = from_xdmf(mp, tp, p=3, dtype=F64, device="cpu")
    u1, v1 = md.solve_n(0.0, DT, 5)
    sw = ShardedGeneralWave(md, 4)
    u4, v4, _ = sw.solve_n(0.0, DT, 5)
    assert max_rel(sw.to_global(v4), v1) <= 1e-13
    assert max_rel(sw.to_global(u4), u1) <= 1e-13


def _mesh_cfg(tmp_path, integrator):
    hm, tags = perturbed_box((4, 2, 2), h=0.002)
    mp, tp = str(tmp_path / "mesh.xdmf"), str(tmp_path / "tags.xdmf")
    io.write_xdmf_mesh(mp, hm)
    io.write_xdmf_meshtags(tp, hm, np.concatenate([tags[1], tags[2]]),
                           [1] * len(tags[1]) + [2] * len(tags[2]))
    return dict(mesh=mp, meshtags=tp, degree=2, dtype="f64", device="cpu",
                integrator=integrator, steps=14, return_state=True)


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_app_mesh_ndev_matches_one_device_and_resumes(tmp_path, integrator):
    """The app's --mesh ... --ndev 2 against one device (1e-12), the JAX
    app's solver_path and the exchange; chunks of 5 with snapshots of the
    global vector, and a resumed call after deleting the newest, end on the
    same state; --output holds the global vector."""
    kw = _mesh_cfg(tmp_path, integrator)
    out1, u1, v1 = planar3d_app.run(**kw)
    out, u, v = planar3d_app.run(ndev=2, output=str(tmp_path / "o.xdmf"), **kw)
    assert out["solver_path"] == f"sharded general ({integrator}, RCB, ndev=2)"
    assert out["exchange"] in ("allgather", "ppermute") and out["ndev"] == 2
    assert out["nsteps"] == out1["nsteps"] == 14
    assert len(u) == 2 and abs(out["u_norm"] - out1["u_norm"]) <= 1e-6 * out1["u_norm"]
    sw = ShardedGeneralWave(from_xdmf(kw["mesh"], kw["meshtags"], p=2, dtype=F64,
                                      device="cpu"), 2)
    assert max_rel(sw.to_global(v), v1) <= TOL and max_rel(sw.to_global(u), u1) <= TOL
    f = io.read_xdmf_attributes(str(tmp_path / "o.xdmf"))
    np.testing.assert_array_equal(f["u"], sw.to_global(u))
    ck = tmp_path / "ck"
    from wave_fenics_tpu_torch.utils.config import SimulationConfig

    cfg = SimulationConfig()
    cfg.run.checkpoint_every_steps = 5
    out2, u2, v2 = planar3d_app.run(cfg, ndev=2, checkpoint_dir=str(ck), **kw)
    assert max_rel(sw.to_global(v2), v1) <= TOL
    snaps = sorted(ck.iterdir())
    assert len(snaps) == 2
    assert np.load(snaps[0])["u"].shape == (out1["ndofs"],)
    snaps[-1].unlink()
    out3, u3, v3 = planar3d_app.run(cfg, ndev=2, checkpoint_dir=str(ck), **kw)
    assert out3["resumed_from_step"] == 5
    assert max_rel(sw.to_global(u3), u1) <= TOL and max_rel(sw.to_global(v3), v1) <= TOL


def test_app_mesh_ndev_main_prints_the_record(tmp_path, capsys):
    kw = _mesh_cfg(tmp_path, "rk4")
    planar3d_app.main(["--mesh", kw["mesh"], "--meshtags", kw["meshtags"], "--degree", "2",
                       "--dtype", "f64", "--device", "cpu", "--steps", "2", "--ndev", "4"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["solver_path"] == "sharded general (rk4, RCB, ndev=4)"
    assert r["ndev"] == 4 and r["exchange"] in ("allgather", "ppermute")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cg_bench_general_ndev(dtype):
    """cg_bench --op general --ndev 4 against one device: iterations within
    1, the solution within the JAX bench's bound, the JAX record's keys."""
    r = cg_bench.run(op="general", size=3, degree=2, ndev=4, device="cpu", dtype=dtype,
                     reps=2)
    assert r["ndev"] == 4 and r["exchange"] in ("allgather", "ppermute")
    assert abs(r["iters"] - r["iters_single_device"]) <= 1 and r["iters"] >= 1
    assert r["max_rel_solution_diff"] < (1e-6 if dtype == "f64" else 1e-2)
    assert r["ndofs"] == 7**3 and r["precond"] is True and "timing" in r
    assert r["metric"].startswith("CG general distributed")


def _fixed_window(monkeypatch):
    """A fixed cost per call, so nothing waits on the host clock."""
    def window(fn, n, device):
        for _ in range(n):
            fn()
        return n * 1e-3 + 5e-3

    monkeypatch.setattr(common, "_window", window)


def test_scatter_cli_local(monkeypatch, capsys):
    _fixed_window(monkeypatch)
    scatter_bench.main(["--mode", "local", "--size", "4", "--reps", "8", "--check",
                        "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["ndofs"] == 17**3 and r["timing"] == "two-point"
    assert abs(r["ms"] - 1.0) <= 1e-9 and r["gdofs_per_s"] > 0


def test_scatter_cli_halo(monkeypatch, capsys):
    _fixed_window(monkeypatch)
    scatter_bench.main(["--mode", "halo", "--size", "4", "--degree", "2", "--ndev", "4",
                        "--reps", "8", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["parts"] == [2, 2, 1] and abs(r["us_per_exchange"] - 1e3) <= 1e-6
    assert r["us_per_fwd_sync"] > 0 and r["face_bytes"] == 5 * 9 * 4


@pytest.mark.parametrize("exchange,key", [("allgather", "interface_slots"),
                                          ("ppermute", "rounds")])
def test_scatter_cli_general_halo(monkeypatch, capsys, exchange, key):
    _fixed_window(monkeypatch)
    scatter_bench.main(["--mode", "general-halo", "--size", "4", "--degree", "2",
                        "--ndev", "4", "--reps", "8", "--exchange", exchange,
                        "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["us_per_exchange"] > 0 and r[key] > 0
    assert r["metric"] == f"unstructured interface assembly ({exchange})"
    if exchange == "ppermute":
        assert r["bucket_slots"] > 0


def test_scatter_general_halo_assembly_matches_jax():
    """The assembly the general-halo mode times, on one input: the port's
    against the JAX package's, part for part."""
    jm, tm = _pair(2, cells=(4, 4, 4), seed=1)
    x = np.random.default_rng(2).standard_normal(tm.ndofs)
    for exchange in ("allgather", "ppermute"):
        js = JSharded(jm, 4, exchange=exchange, use_fused=False)
        ts = ShardedGeneralWave(tm, 4, exchange=exchange)
        tb = js._tables
        names = [n for n in ("bidx", "recv", "sidx", "ridx") if n in tb]

        def local(xb, *ops):
            tloc = {nm: o.reshape(o.shape[1:]) for nm, o in zip(names, ops)}
            return js._assemble(xb.reshape(xb.shape[1:]), tloc).reshape(xb.shape)

        run = jax.jit(shard_map(local, mesh=js.mesh,
                                in_specs=(js.state_spec,) + tuple(tb[n].sharding.spec
                                                                  for n in names),
                                out_specs=js.state_spec, check_vma=False))
        jy = run(js.from_global(x), *[tb[n] for n in names])
        ty = ts._assemble(ts.from_global(x))
        assert _parts_rel(jy, ty, ts) <= 1e-15
