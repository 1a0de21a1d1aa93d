"""The JAX package's ``*-pallas`` rule names, as aliases.

``aggregathor_tpu/gars/pallas_tier.py`` registers kernel-tier variants of
the rules; here every rule already runs its kernel on a CUDA tensor, so the
names map to the same classes and the JAX package's command lines run
unchanged.
"""

from . import register
from .average_nan import AverageNaNGAR
from .averaged_median import AveragedMedianGAR
from .bulyan import BulyanGAR
from .krum import KrumGAR
from .median import MedianGAR
from .trimmed_mean import TrimmedMeanGAR

register("median-pallas", MedianGAR)
register("trimmed-mean-pallas", TrimmedMeanGAR)
register("averaged-median-pallas", AveragedMedianGAR)
register("average-nan-pallas", AverageNaNGAR)
register("krum-pallas", KrumGAR)
register("bulyan-pallas", BulyanGAR)
