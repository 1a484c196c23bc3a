from .ops import rmsnorm
from .kernel import rmsnorm_cuda
from .ref import gated_rmsnorm_ref, rmsnorm_ref

__all__ = ["gated_rmsnorm_ref", "rmsnorm", "rmsnorm_cuda", "rmsnorm_ref"]
