"""The benchmark's own count of work: the card's peaks, the FLOPs each
configuration needs, and kernel #1's (the attention core's) bound.

FLOPs are counted once, by `torch.utils.flop_counter.FlopCounterMode`,
over the plain reference of the configuration run on the `meta` device
(shapes only, nothing computed), never over the program's call: so they
are what the configuration needs, whatever the program runs.  That is
the 7x7 stem as published (no space-to-depth zero taps), the kNN-4 edge
list (N k = 32 pair rows a graph, not the dense grid's N^2 = 64), the
ranking product `[B, Dv] x [Dv, M]` over the M live frames, and the
attention core at its fixed 3 E C^2 a call (6 E C^2 more in a backward,
twice the forward as for a product).  Elementwise work is not counted.

Peaks of one NVIDIA H100 SXM5 (sources beside each).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets, params

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: BF16 tensor core
# 1,979 TFLOP/s with sparsity, so 989.4 dense; FP32 67 TFLOP/s; HBM3
# 3.35 TB/s.
PEAK_BF16 = 989.4e12
PEAK_FP32 = 67.0e12
HBM_BYTES_S = 3.35e12
# NVIDIA Hopper architecture whitepaper: 132 SMs on the H100 SXM5; the
# SM clock under load read by `nvidia-smi --query-gpu=clocks.max.sm` on
# the card the port runs on: 1980 MHz.
SMS = 132
SM_CLOCK_HZ = 1.98e9
# CUDA C++ Programming Guide, "Arithmetic Instructions", throughput per
# clock per SM at compute capability 9.0: 16 results of the special
# function unit (base-2 exponential among them); 128 fp32 add, multiply
# or multiply-add.
SFU_PER_SM_CLOCK = 16
FP32_PER_SM_CLOCK = 128
# An exponential not computed on the special function unit takes at least
# two issued instructions (a range reduction and one fused multiply-add
# at the least), each at no more than the fp32 rate: at most 64 a clock
# per SM, on top of the unit's 16.
EXP_PER_S = (SFU_PER_SM_CLOCK + FP32_PER_SM_CLOCK // 2) * SMS * SM_CLOCK_HZ


def att_core_bound_s(e: int, c: int, in_bytes: int) -> float:
    """The least time of one attention-core call over [E, C] rows: the
    larger of its E C^2 exponentials at `EXP_PER_S` (whatever computes
    them), its 3 E C^2 FLOPs at the bf16 peak, and its bytes (three
    inputs read once, the float32 output written once) at HBM speed."""
    exps = e * c * c
    return max(exps / EXP_PER_S, 3 * exps / PEAK_BF16,
               (3 * e * c * in_bytes + 4 * e * c) / HBM_BYTES_S)


class _Tally:
    def __init__(self):
        self.flops = 0

    def core(self, phi, theta, g, prec):
        return _CountedCore.apply(phi, theta, g, self)


class _CountedCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi, theta, g, tally):
        e, c = phi.shape
        tally.flops += 3 * e * c * c
        ctx.tally = tally
        return torch.empty_like(phi)

    @staticmethod
    def backward(ctx, y_bar):
        e, c = y_bar.shape
        ctx.tally.flops += 6 * e * c * c
        return (torch.empty_like(y_bar),) * 3 + (None,)


def _meta(shape):
    return torch.empty(shape, device="meta")


def serve_flops_per_query(config: dict, traffic: dict) -> float:
    """FLOPs one served query needs: its retrieval descriptor, the ranking
    product over the live database, its encode, the GNN over the kNN edge
    list and the heads."""
    m, b = config["model"], traffic["batch"]
    n, h, w = m["num_nodes"], *m["image_hw"]
    prec = nets.Precision("float32")
    sd = params.meta_weights(params.relpose_spec(m))
    tally = _Tally()
    with FlopCounterMode(display=False) as counter:
        if traffic["retrieval"] == "netvlad":
            r = config["retrieval"]
            nv = params.meta_weights(params.netvlad_spec(r))
            x = nets.netvlad_input(_meta((b, h, w, 3)), r["retrieval_hw"])
            desc = nets.netvlad(nv, r, x, prec)
            emb = nets.encode(sd, m, _meta((b, h, w, 3)), prec)
        else:
            emb = desc = nets.encode(sd, m, _meta((b, h, w, 3)), prec)
        desc @ _meta((desc.shape[1], traffic["db_live"]))
        x = torch.cat([emb[:, None], _meta((b, n - 1, emb.shape[1]))], 1)
        nets.relpose_edges(sd, m, x, prec, core=tally.core)
    return (counter.get_total_flops() + tally.flops) / b


def train_flops_per_graph(config: dict, traffic: dict) -> float:
    """FLOPs one trained graph needs: the forward (BatchNorm on batch
    statistics) and the backward of the loss over the kNN edges."""
    m, b = config["model"], traffic["batch"]
    n, h, w = m["num_nodes"], *m["image_hw"]
    prec = nets.Precision("float32")
    sd = {k: v.requires_grad_(v.is_floating_point())
          for k, v in params.meta_weights(params.relpose_spec(m)).items()}
    crit = {k: _meta(()).requires_grad_() for k in ("srx", "srq")}
    tally = _Tally()
    with FlopCounterMode(display=False) as counter:
        x = nets.encode(sd, m, _meta((b * n, h, w, 3)), prec,
                        train=True).reshape(b, n, -1)
        pred, src, tgt, _ = nets.relpose_edges(sd, m, x, prec,
                                               core=tally.core)
        loss = pred.abs().mean() + crit["srx"] + crit["srq"]
        loss.backward()
    return (counter.get_total_flops() + tally.flops) / b
