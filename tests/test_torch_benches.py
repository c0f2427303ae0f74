"""The port's service and feed benches (relpose_gnn_tpu_torch/benchmarks/) on
the CPU at a tiny size (resnet18, widths 32, 4-node graphs, 4 NetVLAD
clusters, 32x40 frames, float32; the feed bench over 2 x 6 graphs of
3 nodes at 16x20): each runs end to end with `--device cpu`, prints
one parseable JSON line with its documented keys, writes the same record
to `--json`, and reports `mfu` as null off the card (in (0, 1) on one).
The timing helpers are held on their own.
"""

import json

import pytest
import torch

from relpose_gnn_tpu_torch.benchmarks import (_synthetic, _util, bench_eval,
                                              bench_feed,
                                              bench_retrieval_stages,
                                              bench_service,
                                              bench_service_bisect,
                                              train_smoke)
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)

TINY = ["--device", "cpu", "--backbone", "resnet18", "--dims", "32",
        "--seq-len", "4", "--clusters", "4", "--height", "32", "--width",
        "40", "--dtype", "float32", "--iters", "1"]
SERVICE = TINY + ["--batch", "4", "--retrieval-hw", "48", "64"]
DEVICE_KEYS = {"platform", "device", "card"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(capsys, bench, argv, tmp_path):
    """Run a bench; return its record after checking that the last line
    printed and the `--json` file both hold it."""
    path = tmp_path / "record.json"
    out = bench.main([*argv, "--json", str(path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out)) == json.loads(path.read_text())
    assert last["platform"] == "cpu" and last["card"] is None
    return last


def _mfu_ok(mfu):
    return mfu is None or 0.0 < mfu < 1.0


@pytest.mark.parametrize("mode", ["netvlad", "shared-trunk"])
@pytest.mark.parametrize("synth", [True, False])
def test_bench_service(capsys, tmp_path, mode, synth):
    rec = _run(capsys, bench_service, [
        *SERVICE, "--db", "12", "--retrieval-mode", mode, "--host-iters",
        "2", *(["--synth-db"] if synth else [])], tmp_path)
    assert DEVICE_KEYS | {
        "protocol", "batch", "db", "retrieval_mode", "retrieval_hw",
        "rank_dtype", "dtype", "model", "hw", "qps",
        "step_ms", "ms_per_query", "flops_per_step", "mfu",
        "peak_memory_gib", "host_sync_qps", "host_pipelined_qps",
    } == set(rec)
    assert rec["batch"] == 4 and rec["db"] == 12
    assert rec["retrieval_mode"] == mode and rec["retrieval_hw"] == [48, 64]
    assert rec["qps"] == pytest.approx(4 / rec["step_ms"] * 1e3)
    assert rec["flops_per_step"] > 0 and _mfu_ok(rec["mfu"])
    assert rec["host_sync_qps"] > 0 and rec["host_pipelined_qps"] > 0


def test_bench_service_legs_and_bisect_merge(capsys, tmp_path):
    bis = tmp_path / "bisect.json"
    bench_service_bisect.main([*SERVICE, "--db", "20", "--stages",
                               "select,gnn", "--json", str(bis)])
    capsys.readouterr()
    rec = _run(capsys, bench_service, [
        *SERVICE, "--db", "12", "--synth-db", "--skip-host-legs",
        "--rank-dtype", "bfloat16", "--bisect-json", str(bis)], tmp_path)
    assert "host_sync_qps" not in rec and rec["qps"] > 0
    assert rec["rank_dtype"] == "bfloat16"
    assert set(rec["stage_ms"]) == {"select", "gnn"}
    assert rec["stage_ms_config"] == {"batch": 4, "db": 20}
    rec = _run(capsys, bench_service, [
        *SERVICE, "--db", "12", "--synth-db", "--skip-device-leg",
        "--host-iters", "1"], tmp_path)
    assert "qps" not in rec and "mfu" not in rec
    assert rec["host_pipelined_qps"] > 0


@pytest.mark.parametrize("mode,stages", [
    ("netvlad", {"full", "netvlad", "select", "encode", "gnn"}),
    ("shared-trunk", {"full", "select", "encode", "gnn"})])
def test_bench_service_bisect(capsys, tmp_path, mode, stages):
    rec = _run(capsys, bench_service_bisect, [
        *SERVICE, "--db", "20", "--retrieval-mode", mode], tmp_path)
    assert DEVICE_KEYS | {"batch", "db", "retrieval_mode", "retrieval_hw",
                          "rank_dtype", "dtype", "stage_ms"} == set(rec)
    assert set(rec["stage_ms"]) == stages
    assert all(ms > 0 for ms in rec["stage_ms"].values())
    with pytest.raises(SystemExit, match="unknown stages"):
        bench_service_bisect.main([*SERVICE, "--stages", "warp"])


@pytest.mark.parametrize("rank_dtype", ["float32", "bfloat16"])
def test_bench_retrieval_stages(capsys, tmp_path, rank_dtype):
    rec = _run(capsys, bench_retrieval_stages, [
        *TINY, "--batch", "2", "--db", "20", "--retrieval-hw", "48", "64",
        "--rank-dtype", rank_dtype], tmp_path)
    assert list(rec["stages"]) == list(bench_retrieval_stages.STAGES)
    for row in rec["stages"].values():
        assert set(row) == {"ms", "gflop", "tflops", "bf16_peak_share"}
        assert row["ms"] > 0 and _mfu_ok(row["bf16_peak_share"])
    # the stage FLOPs are the convolutions': 2 * H * W * Cin * Cout * 9
    assert rec["stages"]["block1"]["gflop"] * 1e9 == 2 * (
        2 * 48 * 64 * 9 * (3 * 64 + 64 * 64))
    assert rec["stages"]["block5"]["gflop"] * 1e9 == 2 * (
        2 * 3 * 4 * 9 * 3 * 512 * 512)
    assert rec["stages"]["rank"]["gflop"] * 1e9 == 2 * 2 * 20 * 4 * 512
    one = _run(capsys, bench_retrieval_stages, [
        *TINY, "--batch", "2", "--retrieval-hw", "48", "64", "--stage",
        "vlad"], tmp_path)
    assert list(one["stages"]) == ["vlad"]


def test_bench_eval(capsys, tmp_path):
    rec = _run(capsys, bench_eval, [*TINY, "--batch-size", "4",
                                    "--baseline-iters", "2"], tmp_path)
    assert DEVICE_KEYS | {"metric", "value", "unit", "mfu", "step_ms",
                          "step_gflops", "peak_memory_gib", "model", "batch",
                          "dtype", "hw", "self_check_max_err",
                          "self_check_same_anchor", "vs_baseline",
                          "vs_baseline_host_sync", "baseline_qps_device",
                          "baseline_qps_host_sync", "baseline_chain",
                          "baseline_replays", "s2d", "compact",
                          "attention_gflops", "attention_launches"
                          } == set(rec)
    assert rec["metric"] == "relocalization queries/sec/chip"
    assert rec["unit"] == "queries/s"
    assert rec["value"] == pytest.approx(4 / rec["step_ms"] * 1e3)
    assert rec["step_gflops"] > rec["attention_gflops"] > 0
    assert _mfu_ok(rec["mfu"])
    assert not rec["s2d"] and rec["compact"]
    # the baseline legs: on the CPU the chain is a plain loop of 200 calls
    assert rec["baseline_chain"] == "loop" and rec["baseline_replays"] == 200
    assert rec["baseline_qps_device"] > 0 and rec["baseline_qps_host_sync"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / rec["baseline_qps_device"])
    assert rec["vs_baseline_host_sync"] == pytest.approx(
        rec["value"] / rec["baseline_qps_host_sync"])
    assert rec["vs_baseline"] > 0 and rec["vs_baseline_host_sync"] > 0
    assert rec["self_check_same_anchor"]
    assert rec["self_check_max_err"] < 1e-4        # float32: equal anchors
    assert rec["attention_launches"] == 0          # the plain core


FEED = ["--device", "cpu", "--graphs", "6", "--nodes", "3", "--height",
        "16", "--width", "20", "--batch", "2", "--batches", "4"]


def test_bench_feed(capsys, tmp_path):
    rec = _run(capsys, bench_feed, FEED, tmp_path)
    assert DEVICE_KEYS | {"feed", "batch", "stores", "graphs_per_store",
                          "graph_shape"} == set(rec)
    gb = 2 * 3 * 16 * 20 * 3 / 1e9
    legs = rec["feed"]
    assert [r["threads"] for r in legs["native"]] == [1, 2, 4]
    for leg in (legs["numpy"], legs["cached"], *legs["native"]):
        assert leg["batches_per_s"] > 0
        assert leg["gb_per_s"] == pytest.approx(leg["batches_per_s"] * gb)
    cached = legs["cached"]
    assert cached["batches_per_s"] == pytest.approx(
        1e3 / cached["ms_per_batch"])
    # 2 stores x 6 graphs: uint8 images, poses, adj and each row's stats
    assert cached["nbytes"] == 12 * (3 * 16 * 20 * 3 + 3 * 6 * 4 + 9 + 24)
    assert cached["upload_s"] >= 0


SMOKE = ["--device", "cpu", "--steps", "3", "--every", "2", "--batch", "2",
         "--eval-batch", "4", "--backbone", "resnet18", "--dims", "32",
         "--seq-len", "4", "--height", "32", "--width", "40", "--dtype",
         "float32"]


@pytest.mark.parametrize("seed", [0, 1])
def test_train_smoke(capsys, tmp_path, seed):
    lines = []
    path = tmp_path / "record.json"
    rec = train_smoke.main([*SMOKE, "--seed", str(seed), "--json",
                            str(path)], log=lines.append)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(rec)) == json.loads(path.read_text())
    assert DEVICE_KEYS | {"before", "after", "learned", "trajectory",
                          "losses_finite", "steps", "batch", "seed",
                          "eval_batch",
                          "eval_batches", "seconds", "steps_per_s",
                          "attention_launches", "peak_memory_gib", "dtype",
                          "hw"} == set(last)
    assert last["platform"] == "cpu" and last["card"] is None
    # evaluated before training, at step 2 and after the last step
    assert [p["step"] for p in last["trajectory"]] == [0, 2, 3]
    assert last["eval_batches"] == 3 and last["steps"] == 3
    assert last["before"] == last["trajectory"][0]["median_t"]
    assert last["after"] == last["trajectory"][-1]["median_t"]
    assert last["learned"] == (last["after"] < 0.5 * last["before"])
    assert last["losses_finite"] and all(
        p["loss"] is not None and p["t_loss"] > 0
        for p in last["trajectory"][1:])
    assert last["seed"] == seed
    assert last["steps_per_s"] == pytest.approx(3 / last["seconds"])
    # the plain core on the CPU: no kernel launch
    assert last["attention_launches"] == 0
    assert last["peak_memory_gib"] is None
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        "before", "step 2", "step 3"]
    assert len(lines) == 4 and lines[3].startswith("after 3 steps")


def test_benches_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    no_device = [a for a in TINY if a not in ("--device", "cpu")]
    for bench in (bench_service, bench_service_bisect,
                  bench_retrieval_stages, bench_eval):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(no_device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_feed.main(FEED[2:])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_smoke.main(SMOKE[2:])


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


def test_in_turns_order_and_counts():
    calls = []
    forms = {n: (lambda n=n: calls.append(n)) for n in "abc"}
    ms = _util.in_turns(forms, iters=2, warmup=1, device="cpu")
    assert set(ms) == set("abc") and all(v >= 0 for v in ms.values())
    assert calls == list("aaabbbccc" "cccbbbaaa")
    assert calls.count("a") == _util.turn_calls(2, warmup=1)


def test_bound_and_mfu():
    b = _util.bound_ms({"bytes": 3.35e9, "exponentials": 10})
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    b = _util.bound_ms({"bytes": 8, "fp32_ops": 67e9, "tf32_ops": 495e9 * 2})
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2.0)
    assert b["parts"]["fp32"] == pytest.approx(1.0)
    assert _util.mfu(10 ** 12, 1.0, torch.device("cpu")) is None
    assert _util.peak_memory_gib(torch.device("cpu")) is None
    assert _util.device_record(torch.device("cpu"))["platform"] == "cpu"


def test_count_flops_sees_matrix_products():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    assert _util.count_flops(lambda: a @ b) == 2 * 3 * 5 * 7
    assert _util.count_flops(lambda: a + 1) == 0


def test_synth_database_has_build_shapes():
    dev = torch.device("cpu")
    model = _synthetic.pose_model(dev, "R3", None, backbone="resnet18",
                                  feat_dim=32, edge_dim=32, node_dim=32,
                                  num_nodes=4, knn=2)
    assert model.cfg.bn_folded and model.cfg.compact_edges
    enc = _synthetic.netvlad_encoder(dev, 4, None)
    for mode, rank, width in (("netvlad", "bfloat16", 4 * 512),
                              ("shared-trunk", "float32", 32)):
        svc = RelocalizationService(
            model, enc if mode == "netvlad" else None,
            ServiceConfig(seq_len=4, capacity=24, retrieval=mode,
                          rank_dtype=rank), device="cpu")
        _synthetic.synth_database(svc, 20)
        assert tuple(svc.db_desc.shape) == (24, width)
        assert svc.db_desc.dtype == getattr(torch, rank)
        assert svc.db_emb.dtype == torch.float32 and svc.db_count == 20
        assert int(svc.db_valid.sum()) == 20
        norms = svc.db_desc.float().norm(dim=-1)
        assert torch.allclose(norms, torch.ones(24), atol=1e-2)
        frames = _synthetic.synthetic_frames(dev, 3, 32, 40, seed=1)
        assert frames.dtype == torch.uint8 and frames.shape == (3, 32, 40, 3)
        out = svc.query(frames.numpy(), _synthetic.make_norm(dev), 0)
        assert bool(svc.db_valid[out["neighbors"]].all())
    with pytest.raises(ValueError, match="> capacity"):
        _synthetic.synth_database(svc, 25)
