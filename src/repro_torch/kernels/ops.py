"""Public entry to the port's kernels: the wrappers the models call, and the
plain PyTorch versions beside them. Each wrapper takes its plain version for
CPU tensors, launches its hand-written CUDA kernel for CUDA tensors, and on
meta tensors (the dry run) launches nothing and reckons the kernel
(``kernels/reckon.py``)."""
from repro_torch.kernels.betae_kl import betae_kl, betae_kl_ref
from repro_torch.kernels.gather_fuse import (gather_fuse, gather_fuse_backward,
                                             gather_fuse_backward_allowance,
                                             gather_fuse_backward_ref, gather_fuse_params,
                                             gather_fuse_ref, semantic_source)
from repro_torch.kernels.intersect import (intersect, intersect_backward,
                                           intersect_backward_ref, intersect_backward_allowance,
                                           intersect_ref)
from repro_torch.kernels.scoring import (scoring, scoring_aligned, scoring_ref,
                                         scoring_tile)

__all__ = ["betae_kl", "betae_kl_ref",
           "gather_fuse", "gather_fuse_backward", "gather_fuse_backward_allowance",
           "gather_fuse_backward_ref", "gather_fuse_params", "gather_fuse_ref",
           "intersect", "intersect_backward", "intersect_backward_ref",
           "intersect_backward_allowance", "intersect_ref",
           "scoring", "scoring_aligned", "scoring_ref", "scoring_tile", "semantic_source"]
