"""The port's sharded serving database (relpose_gnn_tpu_torch/parallel/
sharded_db.py, RelocalizationService.shard_database) against the JAX
package's and against the port's replicated tables, on the CPU: the JAX
side on four devices of the virtual mesh of tests/conftest.py, the port's
as four gloo ranks spawned by tests/torch_ranks.py (one pool for the whole
module), the cases of tests/test_sharded_db.py.

Tolerances, with their basis (the conventions of tests/test_sharded_db.py):
  * neighbour indices and anchors: exact, against the port's replicated
    service (both selection modes) and against the JAX sharded service
    (deterministic, the port's ranks holding the JAX service's own tables,
    as tests/test_torch_service.py compares queries on the SAME tables;
    the scene's similarity gaps are wide, so the queries' 1e-6 drift
    between the frameworks reorders nothing);
  * poses: rtol = atol = 1e-6 against the replicated service (the
    lookup's all-reduce adds exact zeros, which may turn -0.0 into +0.0;
    each rank encodes the whole query batch, as one process does),
    atol 1e-4 against JAX (tests/test_torch_service.py's bound);
  * `select_and_lookup` on integer tables (every similarity exact, so
    ties are real): indices exact against the JAX function in
    deterministic mode, against the port's dense selection in stochastic
    mode; looked-up rows exact;
  * database state after add / invalidate / compact / save / load:
    exact against the replicated service.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

import torch_ranks
from relpose_gnn_tpu.evaluation import service as jax_service
from relpose_gnn_tpu.models.netvlad import NetVLADEncoder as JaxEncoder
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.parallel import sharded_db as jax_sharded_db
from relpose_gnn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from relpose_gnn_tpu_torch.models.convert import (netvlad_state_dict_from_jax,
                                                  state_dict_from_jax)
from relpose_gnn_tpu_torch.parallel import sharded_db
from relpose_gnn_tpu_torch.retrieval.subsample import \
    subsample_neighbors_batch

SEQ, H, W, RHW = 4, 32, 40, (48, 64)
STAGES = (2, 2, 2, 2)
N_DATA = 4
MODEL_KW = dict(num_nodes=SEQ, feat_dim=32, edge_dim=32, node_dim=32, knn=2,
                backbone="resnet18", droprate=0.0)
SVC = dict(seq_len=SEQ, sampling_period=2, retrieval_hw=RHW)
DEAD = [0, 3, 7, 11, 15]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_scene(n, seed=0, n_fields=3):
    """n frames [n, H, W, 3] in [0, 1]: sliding crops of `n_fields`
    smooth random fields (neighbouring crops overlap, fields differ)."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n_fields):
        f = gaussian_filter(rng.normal(size=(90, 140, 3)), sigma=(5, 5, 0))
        fields.append((f - f.min()) / (f.max() - f.min()))
    per = -(-n // n_fields)
    frames = [fields[i // per][4 * (i % per):4 * (i % per) + H,
                               7 * (i % per):7 * (i % per) + W]
              for i in range(n)]
    return (np.stack(frames).astype(np.float32),
            rng.normal(size=(n, 6)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_weights():
    return torch_ranks.jax_service_weights(SEQ, H, W, RHW,
                                           tuple(sorted(MODEL_KW.items())))


@pytest.fixture(scope="module")
def weights(jax_weights):
    mvars, nvars = jax_weights
    return {"model": torch_ranks.np_state(state_dict_from_jax(
                mvars["params"], mvars["batch_stats"], STAGES)),
            "netvlad": torch_ranks.np_state(netvlad_state_dict_from_jax(
                nvars["params"]))}


@pytest.fixture(scope="module")
def data():
    db, poses = make_scene(16)
    dup = db.copy()
    dup[8:12] = db[0:4]      # equal frames on other ranks: exact ties
    q = np.clip(db[[1, 4, 6, 9, 10, 12, 14, 15]] * 0.98 + 0.01, 0, 1)
    return {"db": db, "poses": poses, "q": q.astype(np.float32),
            "dup": dup}


def _svc(**kw):
    return dict(SVC, **kw)


# (name, service config, ops after the build and the shard)
SCRIPTS = {
    "det_netvlad": (_svc(deterministic=True),
                    [("query", 3), ("invalidate", DEAD), ("query", 0)]),
    "stoch_netvlad": (_svc(retrieval_candidates=8),
                      [("query", 0), ("query", 1), ("query", 7),
                       ("invalidate", DEAD), ("query", 0)]),
    "det_shared": (_svc(deterministic=True, retrieval="shared-trunk"),
                   [("query", 5), ("save", "SNAP"), ("load", "SNAP"),
                    ("state",), ("query", 4)]),
    "stoch_shared": (_svc(retrieval_candidates=8, retrieval="shared-trunk"),
                     [("query", 0), ("query", 1)]),
    "det_bf16": (_svc(deterministic=True, rank_dtype="bfloat16"),
                 [("query", 2)]),
}
MUTATIONS = [("add", 8, 12), ("invalidate", [1, 5]), ("compact",),
             ("state",), ("query", 9), ("add", 12, 16), ("state",)]


def _sharded(snap, ops):
    return [("load", snap), ("shard",), ("state",)] + ops


def _replicated(snap, ops):
    return [("load", snap), ("state",)] + ops


def lookup_inputs(seed=0, m=16, b=6, dv=16, d=8):
    """Integer tables: every similarity is exact in float32 and bfloat16,
    so equal similarities are real ties."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(-2, 3, size=(m, dv)).astype(np.float32)
    desc[9] = desc[2]             # ties across ranks
    desc[14] = desc[2]
    q = rng.integers(-2, 3, size=(b, dv)).astype(np.float32)
    q[0] = desc[2]
    emb = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.ones(m, bool)
    valid[[5, 13]] = False
    return q, desc, emb, valid


LOOKUPS = {
    "lookup_det": dict(deterministic=True, candidates=None),
    "lookup_det_bf16": dict(deterministic=True, candidates=None, bf16=True),
    "lookup_stoch": dict(deterministic=False, candidates=8),
}


def _jax_service(jax_weights, **cfg_kw):
    mvars, nvars = jax_weights
    cfg = jax_service.ServiceConfig(**cfg_kw)
    netvlad = (JaxEncoder(num_clusters=4)
               if cfg.retrieval == "netvlad" else None)
    return jax_service.RelocalizationService(
        JaxRelPoseGNN(JaxConfig(**MODEL_KW)), mvars, netvlad,
        nvars if netvlad is not None else None, cfg)


JAX_CASES = ("det_netvlad", "det_shared")


def _snap_ops(ops, snap):
    return [(op[0], snap) if op[1:] == ("SNAP",) else op for op in ops]


def _case(name, weights, data, cfg, ops):
    return (name, torch_ranks.service_script,
            dict(weights=weights, model_kw=MODEL_KW, svc_kw=cfg, data=data,
                 ops=ops, n_data=N_DATA))


@pytest.fixture(scope="module")
def ranks(weights, jax_weights, data, tmp_path_factory):
    """(every rank-side case of this module, run once on four gloo ranks;
    the same scripts on the port's replicated service, run meanwhile in
    this process; per deterministic JAX case the JAX service's answers
    once sharded over four devices; the sharded snapshot's path).

    Both sides start each script from one replicated build of its
    retrieval mode, made here once and saved (a sharded service is built
    replicated and then sharded, so loading that build's snapshot is the
    same start).  The JAX cases' ranks load the JAX service's tables,
    saved without their fingerprint (the port loads those tables, as
    tests/test_torch_service.py compares queries on the SAME tables);
    they come last, and wait for the files this process writes while
    the ranks run the other cases."""
    tmp = tmp_path_factory.mktemp("sdb")
    snap = str(tmp / "db.npz")
    built = {}
    for key, cfg, frames in (
            ("netvlad", _svc(deterministic=True), data),
            ("shared-trunk", _svc(deterministic=True,
                                  retrieval="shared-trunk"), data),
            ("dup", _svc(deterministic=True), dict(data, db=data["dup"]))):
        built[key] = str(tmp / f"built_{key}.npz")
        torch_ranks.service_script(weights, MODEL_KW, cfg, frames,
                                   [("build", 0, 16), ("save", built[key])])
    cases, refs = [], {}
    for name, (cfg, ops) in SCRIPTS.items():
        start = built[cfg.get("retrieval", "netvlad")]
        cases.append(_case(name, weights, data, cfg,
                           _sharded(start, _snap_ops(ops, snap))))
        refs[name] = (cfg, _replicated(start, _snap_ops(ops, str(tmp /
                                                                 "r.npz"))))
    dup = dict(data, db=data["dup"])
    det = _svc(deterministic=True)
    cases += [
        _case("ties", weights, dup, det,
              _sharded(built["dup"], [("query", 0)])),
        _case("mutations", weights, data, _svc(deterministic=True,
                                               capacity=16),
              [("build", 0, 8), ("shard",)] + MUTATIONS),
        _case("failures", weights, data, det,
              [("build", 0, 10), ("raises", ("shard",))]),
        _case("no_window", weights, data, _svc(retrieval_candidates=None),
              [("build", 0, 4), ("raises", ("shard",))]),
    ]
    q, desc, emb, valid = lookup_inputs()
    cases += [(name, torch_ranks.lookup_case,
               dict(q_desc=q, desc=desc, emb=emb, valid=valid,
                    n_data=N_DATA, k=3, sampling_period=2, seed=11, **kw))
              for name, kw in LOOKUPS.items()]
    nofp = {name: str(tmp / f"{name}_nofp.npz") for name in JAX_CASES}
    cases += [_case(f"jax_{name}", weights, data, SCRIPTS[name][0],
                    [("await", nofp[name]), ("load", nofp[name]),
                     ("shard",), SCRIPTS[name][1][0]])
              for name in JAX_CASES]
    pool = torch_ranks.Ranks(N_DATA, torch_ranks.run_cases, cases,
                             tmp / "ranks")
    jax_svcs = {}
    for name in JAX_CASES:
        svc = _jax_service(jax_weights, **SCRIPTS[name][0])
        svc.build(data["db"], data["poses"], torch_ranks.model_norm,
                  batch=4)
        raw = str(tmp / f"{name}.npz")
        svc.save_database(raw)
        z = dict(np.load(raw))
        for k in ("model_struct", "model_checksum"):
            z.pop(k)
        np.savez(raw + ".part.npz", **z)
        os.replace(raw + ".part.npz", nofp[name])   # whole, or not there
        jax_svcs[name] = svc
    want = {name: replicated(weights, data, cfg, ops)
            for name, (cfg, ops) in refs.items()}
    want["ties"] = replicated(weights, dup, det,
                              [("load", built["dup"]), ("query", 0)])
    want["mutations"] = replicated(
        weights, data, _svc(deterministic=True, capacity=16),
        [("build", 0, 8)] + MUTATIONS)
    jax_want = {}
    for name, svc in jax_svcs.items():
        svc.shard_database(jax_create_mesh(n_data=N_DATA, n_model=1))
        got = svc.query(data["q"], torch_ranks.model_norm,
                        jax.random.PRNGKey(SCRIPTS[name][1][0][1]))
        jax_want[name] = {k: np.asarray(v) for k, v in got.items()}
    for name, kw in LOOKUPS.items():
        if kw["deterministic"]:
            cast = jnp.bfloat16 if kw.get("bf16") else jnp.float32
            nbrs, _ = jax_sharded_db.select_and_lookup(
                jnp.asarray(q), jnp.asarray(desc, cast), jnp.asarray(emb),
                jnp.asarray(valid),
                mesh=jax_create_mesh(n_data=N_DATA, n_model=1),
                axis="data", k=3, sampling_period=2, deterministic=True,
                candidates=None, rng=jax.random.PRNGKey(0))
            jax_want[name] = np.asarray(nbrs)
    return pool.join(), want, jax_want, snap, str(tmp / "r.npz")


def replicated(weights, data, cfg, ops):
    return torch_ranks.to_numpy(torch_ranks.service_script(
        weights, MODEL_KW, cfg, data, ops))


def assert_match(got, want, atol=1e-6):
    np.testing.assert_array_equal(got["neighbors"], want["neighbors"])
    np.testing.assert_array_equal(got["anchor"], want["anchor"])
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=atol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the service: sharded tables against replicated ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sharded_service_matches_the_replicated_one(ranks, name):
    """Every rank answers every query as the replicated service does, in
    both retrieval and both selection modes (the stochastic draws are
    the dense path's, so the same seed selects the same frames), and
    tombstones on every rank are never selected."""
    out, want, _, _, _ = ranks
    _, ops = SCRIPTS[name]
    for rank in out:
        got = rank[name]
        for g, w, op in zip(got[3:], want[name][2:], ops):
            if op[0] == "query":
                assert_match(g, w)
        if ("invalidate", DEAD) in ops:
            assert not np.isin(got[-1]["neighbors"], DEAD).any()


def test_tables_really_shard(ranks):
    """Each rank holds M / 4 rows of desc and emb; poses and valid are
    whole; the tables read back across the ranks are the replicated
    ones."""
    out, want, _, _, _ = ranks
    for rank in out:
        for name in SCRIPTS:
            state = rank[name][2]
            assert state["local_rows"] == 16 // N_DATA
            for k in ("desc", "emb", "poses", "valid", "count"):
                np.testing.assert_array_equal(state[k], want[name][1][k],
                                              err_msg=f"{name} {k}")


def test_equal_frames_on_other_ranks_tie_lower_index_first(ranks):
    out, want, _, _, _ = ranks
    for rank in out:
        assert_match(rank["ties"][3], want["ties"][1])


def test_mutations_keep_the_layout_and_the_state(ranks):
    """add_frames -> invalidate -> compact under the sharded layout: the
    database state (read back across the ranks) is the replicated
    service's bit for bit, the layout survives, the same old_to_new map
    comes back, and queries and later growth still agree."""
    out, want, _, _, _ = ranks
    w = want["mutations"][1:]
    for rank in out:
        got = rank["mutations"][2:]
        np.testing.assert_array_equal(got[2], w[2])          # old_to_new
        for g, r in ((got[3], w[3]), (got[6], w[6])):
            assert g["local_rows"] == 16 // N_DATA
            for k in ("desc", "emb", "poses", "valid", "count"):
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert got[3]["count"] == 10 and got[6]["count"] == 14
        assert_match(got[4], w[4])


def test_save_writes_the_replicated_snapshot_and_load_reshards(ranks):
    out, want, _, snap, ref = ranks
    got_z, want_z = np.load(snap), np.load(ref)
    assert sorted(got_z.files) == sorted(want_z.files)
    for k in want_z.files:
        np.testing.assert_array_equal(got_z[k], want_z[k], err_msg=k)
    w = want["det_shared"]
    for rank in out:
        got = rank["det_shared"]
        assert got[6]["local_rows"] == 16 // N_DATA
        for k in ("desc", "emb", "poses", "valid", "count"):
            np.testing.assert_array_equal(got[6][k], w[5][k], err_msg=k)
        assert_match(got[7], w[6])


def test_loud_failures(ranks):
    out = ranks[0]
    for rank in out:
        assert "must divide" in rank["failures"][1]
        assert "retrieval_candidates" in rank["no_window"][1]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JAX_CASES)
def test_deterministic_sharded_service_matches_jax(ranks, name):
    """The JAX service's tables sharded over four ranks answer the queries
    as the JAX service sharded over four devices does."""
    out, _, jax_want, _, _ = ranks
    want = jax_want[name]
    for rank in out:
        got = rank[f"jax_{name}"][3]
        np.testing.assert_array_equal(got["neighbors"], want["neighbors"])
        np.testing.assert_array_equal(got["anchor"], want["anchor"])
        np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-4)


@pytest.mark.parametrize("name", sorted(LOOKUPS))
def test_select_and_lookup_matches_jax_and_the_dense_selection(ranks,
                                                               name):
    """Deterministic: the JAX function's indices on the same integer
    tables, ties across ranks included.  Stochastic: the port's dense
    windowed selection with the same seed.  Rows: the table's."""
    out, _, jax_want, _, _ = ranks
    q, desc, emb, valid = lookup_inputs()
    kw = LOOKUPS[name]
    if kw["deterministic"]:
        want = jax_want[name]
    else:
        sim = torch.from_numpy(q) @ torch.from_numpy(desc).T
        want = subsample_neighbors_batch(
            11, sim, ~torch.from_numpy(valid), 3, 2,
            candidates=kw["candidates"]).numpy()
    for rank in out:
        got = rank[name]
        np.testing.assert_array_equal(got["nbrs"], want)
        np.testing.assert_array_equal(got["emb"], emb[want])
    assert not np.isin(want, [5, 13]).any()


def test_stochastic_window_matches_jax():
    for m, k, c in ((16, 3, 8), (2048, 7, 256), (300, 7, 257), (5, 7, 8)):
        assert sharded_db.stochastic_window(m, k, c) == \
            jax_sharded_db.stochastic_window(m, k, c)
