"""Faults planted in the timed path, to show that the check fails them.

Not used by a benchmark run: `calibrate.py` plants them on the card at
the cell's size to read what each number gives, and the CPU tests plant
them at a small size to see `correct` come out false.

* `half_batch`: serving answers the first half of each batch and copies
  those answers onto the second half; training takes the mean over the
  first half of each batch only.
* `altered`: one served answer of each batch is altered where it is
  produced (its pose moved by one unit).
* `unchanged`: the train step returns its state unchanged (parameters
  put back and Adam's moments zeroed after the step).
"""

from __future__ import annotations

import torch

NAMES = ("half_batch", "altered", "unchanged")


class Fault:
    def __init__(self, name: str):
        if name not in NAMES:
            raise ValueError(f"fault {name!r}: one of {NAMES}")
        self.name = name

    def service(self, svc):
        """The service with its `query` broken (for the serve driver)."""
        real = svc.query

        def query(images, model_norm, rng=None, norm_ms=None):
            out = real(images, model_norm, rng, norm_ms=norm_ms)
            if self.name == "half_batch":
                b = out["pose"].shape[0]
                h = (b + 1) // 2
                out = {k: torch.cat([v[:h], v[:b - h]]) for k, v in
                       out.items()}
            elif self.name == "altered":
                out = dict(out, pose=out["pose"].clone())
                out["pose"][min(3, out["pose"].shape[0] - 1)] += 1.0
            return out

        svc.query = query
        return svc

    def train_step(self, step):
        """The train step broken (for the train driver)."""
        if self.name == "half_batch":
            def half(state, batch, seed):
                b = batch["images"].shape[0]
                return step(state, {k: v[:b // 2] for k, v in batch.items()},
                            seed)
            return half
        if self.name == "unchanged":
            def unchanged(state, batch, seed):
                keep = [p.detach().clone() for p in state.optimizer.params]
                metrics = step(state, batch, seed)
                with torch.no_grad():
                    for p, k in zip(state.optimizer.params, keep):
                        p.copy_(k)
                    for st in state.optimizer.adam.state.values():
                        st["exp_avg"].zero_()
                        st["exp_avg_sq"].zero_()
                return metrics
            return unchanged
        return step
