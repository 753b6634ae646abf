# Hand-written Hopper kernels (csrc/*.cu) for the pooled hot spots, each with
# its plain PyTorch version beside it; ops.py is the entry the models call.
