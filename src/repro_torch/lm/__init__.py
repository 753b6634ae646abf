"""The LM architecture zoo in PyTorch: the JAX package's ``lm/`` model code
(config, building blocks, attention, Mamba2/SSD, MoE, the decoder stack and
its train/prefill/decode steps), computed in bf16 at the reference's cast
points with fp32 masters. Its matrix products are ``torch.matmul``/``einsum``:
``lm/`` reaches no Pallas kernel. Over a mesh each step runs one rank's
program (``lm/parallel.py``); ``lm/shapes.py`` holds the dry run's shape
cells (``launch/dryrun.py``)."""
