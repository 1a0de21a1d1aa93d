"""Lossy-link simulator: UDP packet loss as NaN runs in the gradient rows.

Counterpart of ``aggregathor_tpu/parallel/lossy.py``.  The reference's
patched transport ships gradients in 65000-byte UDP datagrams and fills lost
packets with NaN on the parameter server; only the first k workers are lossy,
and only for tensors above ~1 MB.  Here, per step, each lossy worker drops
whole "packets" (runs of ``packet-coords`` contiguous coordinates in the JAX
coordinate order) i.i.d. at ``drop-rate``, and a dropped run becomes NaN,
which the NaN-aware rules (average-nan, the +inf-distance convention of Krum
and Bulyan) absorb.  ``clever:true`` keeps the previous step's received value
instead (the reference's ``CLEVER=1``); the engine carries it in
``TrainState.carry``.

The draw and the masking are two steps: ``draw_drops`` reads the (seed, step,
worker, tag 2) stream on a CPU generator, so one run drops the same packets
on the card and on the CPU, and ``apply_rows`` masks a rank's rows with any
given drops in one pass (the tests feed it the JAX package's own draws,
whose threefry bits a torch generator cannot reproduce).  The engine's
``--UDP`` link and a chaos regime's drop storm both go through it.
"""

import torch

from ..utils import UserException, parse_keyval

#: 65000-byte datagrams of float32 coordinates
PACKET_COORDS = 65000 // 4
#: the lossy transport engages only above ~1 MB tensors
MIN_LOSSY_COORDS = (1 << 20) // 4
#: stream tag of the lossy link, as the JAX engine folds it (attack: 1)
LOSSY_TAG = 2


class LossyLink:
    """Packet-loss masking for the first ``nb_lossy`` workers."""

    def __init__(self, nb_lossy, args=None):
        kv = parse_keyval(args or [], {
            "drop-rate": 0.01,
            "packet-coords": PACKET_COORDS,
            "min-coords": MIN_LOSSY_COORDS,
            "clever": False,
        })
        self.nb_lossy = int(nb_lossy)
        self.drop_rate = float(kv["drop-rate"])
        self.packet_coords = int(kv["packet-coords"])
        self.min_coords = int(kv["min-coords"])
        self.clever = bool(kv["clever"])

    def nb_packets(self, d):
        return -(-d // self.packet_coords)

    def draw_drops(self, d, seed, step, worker, drop_rate=None, tag=LOSSY_TAG):
        """(nb_packets,) bool CPU tensor: which packets of worker ``worker``'s
        (d,) row are lost at ``step``, from the (seed, step, worker, 2) stream
        (the sharded mode passes its leaf's ``tag``); ``drop_rate``
        overrides the configured rate (a chaos regime's storm)."""
        from .engine import stream_generator

        rate = self.drop_rate if drop_rate is None else float(drop_rate)
        generator = stream_generator(seed, step, worker, tag, torch.device("cpu"))
        return torch.rand(self.nb_packets(d), generator=generator) < rate

    def apply_rows(self, rows, workers, drops, previous=None):
        """Mask the lost packets of the (k, d) ``rows`` of workers
        ``workers`` (k global indices), in one pass.

        Applies to the rows of workers ``w < nb_lossy`` when ``d`` is at least
        ``min-coords``; ``drops`` is the (k, nb_packets) CPU loss draw, copied
        to the rows' device once (through pinned memory on CUDA), and
        ``previous`` the (k, d) stale infill of clever mode."""
        d = rows.shape[-1]
        if self.nb_lossy <= 0 or d < self.min_coords:
            return rows
        if self.clever and previous is None:
            raise UserException(
                "LossyLink clever:true needs the previous gradient; run it through "
                "RobustEngine (which carries it in TrainState.carry) or pass previous="
            )
        lossy = torch.tensor([w < self.nb_lossy for w in workers])
        if not bool(lossy.any()):
            return rows
        drops = drops & lossy[:, None]
        if rows.device.type == "cuda":
            # the caching host allocator keeps the pinned block until the copy is done
            drops = drops.pin_memory().to(rows.device, non_blocking=True)
        else:
            drops = drops.to(rows.device)
        mask = drops.repeat_interleave(self.packet_coords, dim=1)[:, :d]
        infill = previous if self.clever else torch.full((), float("nan"), dtype=rows.dtype, device=rows.device)
        return torch.where(mask, infill, rows)
