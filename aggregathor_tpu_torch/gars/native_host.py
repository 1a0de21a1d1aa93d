"""The ``*-native`` rule names: the host C++ library on the dense path.

Counterpart of ``aggregathor_tpu/gars/native_host.py``: each
``<rule>-native`` name's dense ``aggregate`` runs the host library
(``ops/native``, built with ``c++`` at the first construction of such a
rule) on a numpy copy of the rows and returns the result on the rows'
device, in their dtype (a numpy input returns numpy).  That is the
reference's host tier chosen by name, not a fallback.

In the engine the rule is called through ``_call_aggregate`` and
``aggregate_block``, which the classes inherit from the card tier, as the
JAX classes inherit the jnp tier: ``krum-native`` in a training run is K1
and Krum on the card.  A machine without a C++ compiler refuses the names
with a UserException at construction.
"""

import numpy as np
import torch

from ..ops import native
from . import register
from .average import AverageGAR
from .average_nan import AverageNaNGAR
from .averaged_median import AveragedMedianGAR
from .bulyan import BulyanGAR
from .krum import KrumGAR
from .median import MedianGAR


class _NativeMixin:
    """Builds and loads the host library at construction."""

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        try:
            native.load()
        except Exception as exc:
            from ..utils import UserException

            raise UserException("%s requires the native GAR library: %s" % (type(self).__name__, exc)) from exc


def _dense(host_fn):
    """An ``aggregate`` running ``host_fn(self, numpy rows) -> (d,)`` on the
    host and returning the result where the rows live."""

    def aggregate(self, grads, key=None):
        if isinstance(grads, np.ndarray):
            return host_fn(self, grads)
        host = grads.detach().cpu().numpy()
        if host.dtype not in (np.float32, np.float64):
            host = host.astype(np.float64)
        return torch.from_numpy(host_fn(self, host)).to(device=grads.device, dtype=grads.dtype)

    return aggregate


class NativeAverageGAR(_NativeMixin, AverageGAR):
    aggregate = _dense(lambda self, g: native.average(g))


class NativeAverageNaNGAR(_NativeMixin, AverageNaNGAR):
    aggregate = _dense(lambda self, g: native.average_nan(g))


class NativeMedianGAR(_NativeMixin, MedianGAR):
    aggregate = _dense(lambda self, g: native.median(g))


class NativeAveragedMedianGAR(_NativeMixin, AveragedMedianGAR):
    aggregate = _dense(lambda self, g: native.averaged_median(g, self.nb_byz_workers))


class NativeKrumGAR(_NativeMixin, KrumGAR):
    aggregate = _dense(lambda self, g: native.krum(g, self.nb_byz_workers, self.nb_selected))


class NativeBulyanGAR(_NativeMixin, BulyanGAR):
    aggregate = _dense(lambda self, g: native.bulyan(g, self.nb_byz_workers))


register("average-native", NativeAverageGAR)
register("average-nan-native", NativeAverageNaNGAR)
register("median-native", NativeMedianGAR)
register("averaged-median-native", NativeAveragedMedianGAR)
register("krum-native", NativeKrumGAR)
register("bulyan-native", NativeBulyanGAR)
