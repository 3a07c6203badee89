"""Faults planted underneath the timed path, for the tests that see the
output check come out false (and for ``calibrate.py --fault``):

* ``half_points``: each call of the point or column MLP scores only the
  first half of its points or columns; the rest read 0;
* ``altered``: each subject's HR field is raised by 0.05 where the
  program produces it, before extraction;
* ``unchanged``: the training step leaves the parameters as they were
  (the optimizer's update is zero; its moments still move);
* ``half_batch``: the training loss is the mean over the first half of
  the batch's rows alone.

``plant(name)`` returns a function that takes the fault off.
"""

from __future__ import annotations

from typing import Callable


def plant(name: str) -> Callable[[], None]:
    from surs_tpu_torch.recon import evaluator, pipeline
    if name == "half_points":
        query, cols = pipeline.fused_query, evaluator.fused_dual_mlp_cols

        def half_query(*a, **kw):
            hr, lr = query(*a, **kw)
            n = hr.shape[-1]
            hr, lr = hr.clone(), lr.clone()
            hr[..., n // 2:] = 0.0
            lr[..., n // 2:] = 0.0
            return hr, lr

        def half_cols(*a, **kw):
            hr, lr = cols(*a, **kw)
            n = hr.shape[0]
            hr[n // 2:] = 0.0
            lr[n // 2:] = 0.0
            return hr, lr

        pipeline.fused_query = half_query
        evaluator.fused_dual_mlp_cols = half_cols

        def undo():
            pipeline.fused_query = query
            evaluator.fused_dual_mlp_cols = cols
        return undo
    if name == "altered":
        extract = pipeline.Reconstructor.extract_pair

        def raised(sdf_hr, sdf_lr, *a, **kw):
            return extract(sdf_hr + 0.05, sdf_lr, *a, **kw)

        pipeline.Reconstructor.extract_pair = staticmethod(raised)

        def undo():
            pipeline.Reconstructor.extract_pair = staticmethod(extract)
        return undo
    if name == "unchanged":
        from surs_tpu_torch.train import optim
        update = optim.OptaxOptimizer._update

        def zero(self, *a, **kw):
            return update(self, *a, **kw) * 0.0

        optim.OptaxOptimizer._update = zero

        def undo():
            optim.OptaxOptimizer._update = update
        return undo
    if name == "half_batch":
        from surs_tpu_torch.train import fused_step, step
        fused, plain = fused_step.fused_train_loss, step.train_loss

        def half(batch):
            n = batch["images_lr"].shape[0] // 2
            return {k: v[:n] for k, v in batch.items()}

        fused_step.fused_train_loss = \
            lambda m, batch, op=None: fused(m, half(batch), op)
        step.train_loss = lambda m, batch: plain(m, half(batch))

        def undo():
            fused_step.fused_train_loss = fused
            step.train_loss = plain
        return undo
    raise ValueError(f"unknown fault {name!r}")
