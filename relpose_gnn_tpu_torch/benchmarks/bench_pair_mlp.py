"""Microbenchmark: the fused pair-MLP kernel against two library forms.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_pair_mlp            # N=8
    python -m relpose_gnn_tpu_torch.benchmarks.bench_pair_mlp --nodes 32

Counterpart of the JAX package's `benchmarks/bench_pallas_gnn.py`.  On a
batch of `--batch` graphs of `--nodes` nodes with every width `--dims`, in
bfloat16, it first checks the kernel against the concat form (relative max
difference, printed; the concat form's last linear rounds its output to
bfloat16, so about 2^-9 is expected), then times three ways to compute the
edge MLP:

  kernel   `ops/pair_mlp.py::pair_mlp_apply` (the hand-written CUDA kernel)
  concat   materialise [xs | xt | e], `F.linear -> relu -> F.linear`
  split    split-weight form (what `models/gnn.py::PairMLP2` computes):
           node slabs once per node, broadcast-add, one per-pair product

Timing: CUDA events around each call, median of `--iters` after warm-up,
the three forms in turns (kernel, concat, split, split, concat, kernel) so
that drift of the card's clocks falls on all alike.  Weights are cast to
bfloat16 once, outside the timed calls, for all three forms; the casts of
x and e are inside, as in the JAX bench.  Runs on the CUDA card unless
`--device cpu` asks otherwise (the kernel's plain version then stands in,
which measures nothing of the card).
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.ops import pair_mlp

WARMUP = 2
TURNS = ("kernel", "concat", "split", "split", "concat", "kernel")


def concat_form(x, e, fc1_w, fc1_b, fc2_w, fc2_b):
    """[xs | xt | e] materialised, two bf16 linears; float32 out.
    fc1_w [H, 2D + De] and fc2_w [Dout, H] are torch-oriented bf16."""
    b, n, d = x.shape
    xs = x[:, :, None, :].expand(b, n, n, d)
    xt = x[:, None, :, :].expand(b, n, n, d)
    inp = torch.cat([xs, xt, e], -1).to(torch.bfloat16)
    h = F.relu(F.linear(inp, fc1_w).float() + fc1_b)
    return F.linear(h.to(torch.bfloat16), fc2_w).float() + fc2_b


def split_form(x, e, fc1_w, fc1_b, fc2_w, fc2_b):
    """Node slabs once per node + broadcast-add: fewer FLOPs, no concat."""
    d = x.shape[-1]
    xb, eb = x.to(torch.bfloat16), e.to(torch.bfloat16)
    hs = F.linear(xb, fc1_w[:, :d])                   # [B, N, H]
    ht = F.linear(xb, fc1_w[:, d:2 * d])
    he = F.linear(eb, fc1_w[:, 2 * d:])               # [B, N, N, H]
    h = F.relu((hs[:, :, None] + ht[:, None, :] + he).float() + fc1_b)
    return F.linear(h.to(torch.bfloat16), fc2_w).float() + fc2_b


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--dims", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    b, n, d = args.batch, args.nodes, args.dims
    de = h = d
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        return torch.as_tensor(
            (rng.normal(size=shape) * scale).astype(np.float32),
            device=device)

    x, e = arr(b, n, d), arr(b, n, n, de)
    fc1k = arr(2 * d + de, h, scale=0.02).to(torch.bfloat16)   # [in, out]
    fc2k = arr(h, de, scale=0.02).to(torch.bfloat16)
    fc1b = torch.zeros(h, device=device)
    fc2b = torch.zeros(de, device=device)
    fc1w, fc2w = fc1k.T.contiguous(), fc2k.T.contiguous()      # [out, in]

    forms = {
        "kernel": lambda: pair_mlp.pair_mlp_apply(
            x, e, fc1k, fc1b, fc2k, fc2b, mode="edge",
            dtype=torch.bfloat16),
        "concat": lambda: concat_form(x, e, fc1w, fc1b, fc2w, fc2b),
        "split": lambda: split_form(x, e, fc1w, fc1b, fc2w, fc2b),
    }

    # correctness first: the kernel against the concat form at these shapes
    out_k, out_c = forms["kernel"](), forms["concat"]()
    diff = float((out_k - out_c).abs().max()
                 / (out_c.abs().max() + 1e-9))
    print(f"B={b} N={n} D={de}  rel max diff kernel vs concat bf16: "
          f"{diff:.2e}", flush=True)

    flops = 2 * b * n * n * h * (3 * d + de)
    runs: dict[str, list[float]] = {k: [] for k in forms}
    for name in TURNS:
        runs[name].append(_util.median_ms(forms[name], args.iters, WARMUP,
                                            device))
    results = {k: statistics.mean(v) for k, v in runs.items()}
    for name, label in (("kernel", "kernel            "),
                        ("concat", "concat bf16       "),
                        ("split", "split-weight bf16 ")):
        t = results[name]
        print(f"{label}: {t:8.3f} ms  ({runs[name][0]:.3f} / "
              f"{runs[name][1]:.3f})  {flops / t / 1e9:7.1f} TFLOP/s"
              f"{'-equivalent' if name == 'split' else ''}", flush=True)
    best_lib = min(results["concat"], results["split"])
    print(f"verdict: kernel {results['kernel']:.3f} ms vs library best "
          f"{best_lib:.3f} ms at N={n} on {device}", flush=True)
    return {"rel_max_diff": diff, "ms": results, "flops": flops,
            "kernel_calls": 1 + TURNS.count("kernel")
            * (WARMUP + args.iters)}


if __name__ == "__main__":
    main(sys.argv[1:])
