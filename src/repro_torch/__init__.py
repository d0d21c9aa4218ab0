"""PyTorch/CUDA port of the online annealing resource manager.

A second package beside the JAX reference (``src/repro``): the same
controllers, with plain tensor code in PyTorch and the TPU kernels
rewritten by hand for Hopper (``repro_torch.kernels``).  It imports
neither JAX nor the reference package.  Entry points take ``device``
(default ``"cuda"``); pass ``device="cpu"`` to run the plain versions.
"""
