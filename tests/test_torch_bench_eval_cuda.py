"""The headline bench's device chain on the card: the batch-1 reference
program captured in a CUDA graph, replayed, and its accumulator held
against the eager step; and `bench_eval.main` at a narrow size with both
baseline legs and each form.  Every case skips where there is no card.
Nothing of JAX or of the JAX package is imported, so that the card's
machine (which has no flax) can collect this file:

    python -m pytest tests/test_torch_bench_eval_cuda.py -m gpu

Tolerance: the accumulator within rtol 1e-4 of the replays times the
eager step's sum(pred) (`bench_eval.CHAIN_RTOL`; float32 sums of equal
terms).
"""

import pytest
import torch

from relpose_gnn_tpu_torch.benchmarks import _synthetic, bench_eval
from relpose_gnn_tpu_torch.ops import att_core

N, D, H, W = 8, 64, 64, 80
NARROW = ["--backbone", "resnet18", "--dims", str(D), "--height", str(H),
          "--width", str(W), "--batch-size", "16", "--iters", "3",
          "--baseline-iters", "4"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the attention kernel has no CPU "
                    "mode and a CUDA graph needs a card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_device_chain_replays_a_cuda_graph(cuda_device, dtype):
    model = _synthetic.unfolded_pose_model(
        cuda_device, "R3", dtype, 0, backbone="resnet18", feat_dim=D,
        edge_dim=D, node_dim=D)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    images = torch.randn(1, N, H, W, 3, device=cuda_device, generator=gen)
    poses = torch.randn(1, N, 6, device=cuda_device, generator=gen)
    adj = (~torch.eye(N, dtype=torch.bool, device=cuda_device))[None]

    def step():
        return bench_eval.reference_program(model, images, adj, poses)

    replays = 50
    with torch.inference_mode():
        eager = float(step()[0].sum())
        before = att_core.LAUNCHES
        out = bench_eval.device_chain(step, replays, cuda_device)
    # eager: the reference sum and the warm-ups; then the two GNN passes
    # as they are captured (recorded into the graph, not run)
    assert att_core.LAUNCHES - before == 2 * (1 + bench_eval.CHAIN_WARMUP) + 2
    assert out["chain"] == "cuda_graph" and out["captured_launches"] == 2
    assert out["replays"] == replays + bench_eval.CHAIN_WARMUP
    assert out["qps"] > 0
    assert out["acc"] == pytest.approx(replays * eager,
                                       rel=bench_eval.CHAIN_RTOL)
    assert out["acc"] == pytest.approx(out["want"],
                                       rel=bench_eval.CHAIN_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [[], ["--s2d"], ["--no-compact"]])
def test_main_on_the_card(cuda_device, argv):
    before = att_core.LAUNCHES
    rec = bench_eval.main([*NARROW, *argv])
    assert rec["platform"] == "gpu" and rec["baseline_chain"] == "cuda_graph"
    assert rec["baseline_replays"] == 200 + bench_eval.CHAIN_WARMUP
    assert rec["baseline_qps_device"] > 0 and rec["baseline_qps_host_sync"] > 0
    assert rec["vs_baseline"] > 0 and 0.0 < rec["mfu"] < 1.0
    assert rec["self_check_max_err"] < bench_eval.SELF_CHECK_TOL
    # each replay ran the two launches it captured; the capture ran none
    assert rec["attention_launches"] == (
        att_core.LAUNCHES - before - 2 + 2 * rec["baseline_replays"])
