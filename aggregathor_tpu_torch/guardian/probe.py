"""In-step health probe: the fields the engine nests under ``metrics["probe"]``.

Counterpart of ``aggregathor_tpu/guardian/probe.py``, in float32 on the
step's device (no host read):

- ``loss_finite``      int32 0/1: is this step's total loss finite;
- ``update_norm``      float32: L2 norm of the aggregate the optimizer
  applied (the value of ``grad_norm``, under the probe's own key);
- ``spike``            float32: |loss| over the EMA of the recent |loss|
  (``EMA_DECAY``), against the previous step's EMA; 1.0 while the EMA is
  unset, +inf when the loss is not finite;
- ``worker_nan_rows``  (n,) int32 0/1: which workers' rows as they arrived
  (after the lossy link, before the omniscient attack) held a non-finite
  coordinate.

The EMA lives in ``TrainState.loss_ema``, a side buffer never saved: it
re-warms from ``EMA_UNSET`` after a restore.
"""

import torch

#: metrics key under which the engine nests the probe fields
PROBE_KEY = "probe"

#: EMA decay of the |loss| reference the spike score divides by
EMA_DECAY = 0.9

#: "no EMA accumulated yet" (|loss| is never negative)
EMA_UNSET = -1.0


def update_loss_ema(prev_ema, loss):
    """The next EMA of |loss|: seeded by the first finite loss, held at its
    last value through non-finite steps."""
    loss32 = torch.abs(loss.to(torch.float32))
    seeded = torch.where(prev_ema < 0.0, loss32, EMA_DECAY * prev_ema + (1.0 - EMA_DECAY) * loss32)
    return torch.where(torch.isfinite(loss32), seeded, prev_ema)


def spike_score(loss, prev_ema):
    """|loss| / EMA(|loss|) against the previous step's EMA; 1.0 while the
    EMA is unset, +inf for a non-finite loss."""
    loss32 = torch.abs(loss.to(torch.float32))
    ref = torch.clamp_min(prev_ema, 1e-8)
    score = torch.where(prev_ema < 0.0, torch.ones_like(loss32), loss32 / ref)
    return torch.where(torch.isfinite(loss32), score, torch.full_like(loss32, torch.inf))


def probe_metrics(total_loss, update_norm, spike, worker_nan_rows):
    """The probe sub-dictionary the engine nests under ``PROBE_KEY``."""
    return {
        "loss_finite": torch.isfinite(total_loss).to(torch.int32),
        "update_norm": update_norm,
        "spike": spike,
        "worker_nan_rows": worker_nan_rows.to(torch.int32),
    }


def host_view(metrics):
    """Numpy view of one call's probe, or None when the engine ran without
    it.  Under ``--unroll`` each field has a leading K, one entry a step."""
    if PROBE_KEY not in metrics:
        return None
    return {name: value.detach().cpu().numpy() for name, value in metrics[PROBE_KEY].items()}
