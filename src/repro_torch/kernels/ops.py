"""Public entry to the port's kernels: the wrappers the models call, and the
plain PyTorch versions beside them. Each wrapper takes its plain version for
CPU tensors and launches its hand-written CUDA kernel for CUDA tensors."""
from repro_torch.kernels.intersect import intersect, intersect_ref
from repro_torch.kernels.scoring import scoring, scoring_ref

__all__ = ["intersect", "intersect_ref", "scoring", "scoring_ref"]
