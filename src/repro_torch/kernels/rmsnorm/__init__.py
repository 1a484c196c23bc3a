from .ops import gated_rmsnorm, rmsnorm
from .kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from .ref import gated_rmsnorm_ref, rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["gated_rmsnorm", "gated_rmsnorm_ref", "rmsnorm",
           "rmsnorm_bwd_cuda", "rmsnorm_bwd_ref", "rmsnorm_cuda",
           "rmsnorm_ref"]
