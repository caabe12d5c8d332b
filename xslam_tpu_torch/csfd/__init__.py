"""CSFD/DCSFD number core over PyTorch tensors: dual and hyper-dual arithmetic.

Port of ``xslam_tpu/csfd``. See :mod:`xslam_tpu_torch.csfd.single` for the
first-order lane and :mod:`xslam_tpu_torch.csfd.double` for the second.
"""

from . import double, rawcomplex, single, vec3
from .double import DCSFD
from .single import CSFD, lift

__all__ = ["CSFD", "DCSFD", "single", "double", "vec3", "rawcomplex", "lift"]
